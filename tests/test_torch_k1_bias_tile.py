"""A numpy model of the layout K1's bias tile is meant to have
(``csrc/attention_sm90.cuh``); the kernel itself runs only on the card.

The producer warp's TMA writes a bias tile, 64 query rows x 128 keys of
bf16, as two boxes of 64 keys with the 128-byte swizzle: 16-byte chunk c
of row R lands at chunk c ^ (R % 8) of its 128-byte row.  Each consumer
lane computes one ldmatrix row address per warp (``bias_lane``) and moves
it to key octet pair (j, j + 1) with an xor and a box offset
(``score_tile``); ldmatrix.x4 hands lane 4g + t, from matrix i, the word
at row g, columns 2t and 2t + 1.  The tests hold that every lane then
holds the bias of exactly the scores its wgmma accumulator holds (row g
or g + 8 of its warp's 16, column 8j + 2t (+1)), and that each 8-address
phase of an ldmatrix touches 32 distinct banks: no bank conflict.

This holds the intended layout, not the compiled kernel: the model's
address formulas are copies, and the last test only checks that the
kernel's source still spells the same expressions.  No bank-conflict
counter has been read on the card.
"""

from pathlib import Path

import numpy as np
import pytest

HEADER = (Path(__file__).resolve().parents[1] / "mlmicroservicetemplate_tpu_torch"
          / "csrc" / "attention_sm90.cuh")

ROWS, KEYS, BOX_KEYS = 64, 128, 64
BOX_BYTES = ROWS * BOX_KEYS * 2  # 8 KB


def swizzled_tile(bias: np.ndarray) -> np.ndarray:
    """The tile's bytes as TMA writes them: two [64, 64] bf16 boxes, each
    row 128 B, chunk c of row r at chunk c ^ (r % 8)."""
    out = np.zeros(2 * BOX_BYTES, np.uint8)
    raw = bias.astype(np.uint16)
    for box in range(2):
        for r in range(ROWS):
            row = raw[r, box * BOX_KEYS:(box + 1) * BOX_KEYS].view(np.uint8)
            for c in range(8):
                dst = box * BOX_BYTES + r * 128 + ((c ^ (r % 8)) * 16)
                out[dst:dst + 16] = row[c * 16:(c + 1) * 16]
    return out


def bias_lane(warp: int, lane: int) -> int:
    """The kernel's per-lane ldmatrix row address in the tile (stage 0,
    the tile at offset 0)."""
    mi, i = lane // 8, lane % 8
    return (warp * 16 + 8 * (mi % 2) + i) * 128 + (((mi // 2) ^ i) << 4)


def pair_address(base: int, j: int) -> int:
    """The lane's address for key octets j, j + 1 (j even)."""
    return (base ^ ((j % 8) << 4)) + (j // 8) * BOX_BYTES


def ldmatrix_x4(tile: np.ndarray, addrs: list[int]) -> np.ndarray:
    """[32 lanes, 4] uint32: lane 4g + t gets, from matrix i (rows at the
    addresses of lanes 8i .. 8i + 7), the word at row g, bytes 4t .. 4t + 3."""
    out = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            a = addrs[8 * i + g] + 4 * t
            out[lane, i] = tile[a:a + 4].view(np.uint32)[0]
    return out


@pytest.fixture(scope="module")
def tile():
    # a distinct 16-bit value per (row, key): its own coordinates
    bias = (np.arange(ROWS)[:, None] * KEYS + np.arange(KEYS)[None, :]).astype(np.uint16)
    return bias, swizzled_tile(bias)


@pytest.mark.parametrize("warp", range(4))
def test_every_lane_reads_the_bias_of_its_accumulator_scores(tile, warp):
    bias, data = tile
    bases = [bias_lane(warp, lane) for lane in range(32)]
    for j in range(0, KEYS // 8, 2):
        words = ldmatrix_x4(data, [pair_address(b, j) for b in bases])
        for lane in range(32):
            g, t = lane // 4, lane % 4
            # score entries 4j .. 4j + 7 of the lane: (row half, octet) of
            # matrices (0, j), (1, j), (0, j + 1), (1, j + 1)
            for i in range(4):
                row = warp * 16 + g + 8 * (i % 2)
                col = 8 * (j + i // 2) + 2 * t
                lo, hi = int(words[lane, i]) & 0xFFFF, int(words[lane, i]) >> 16
                assert (lo, hi) == (bias[row, col], bias[row, col + 1]), (warp, j, lane, i)


@pytest.mark.parametrize("warp", range(4))
def test_each_ldmatrix_phase_is_free_of_bank_conflicts(warp):
    bases = [bias_lane(warp, lane) for lane in range(32)]
    for j in range(0, KEYS // 8, 2):
        addrs = [pair_address(b, j) for b in bases]
        for i in range(4):  # one phase per matrix: its 8 row addresses
            banks = {(a // 4 + w) % 32 for a in addrs[8 * i:8 * i + 8] for w in range(4)}
            assert len(banks) == 32, (warp, j, i)


def test_without_the_swizzle_the_rows_would_conflict():
    """The premise of the swizzle: unswizzled, a phase's 8 rows (128 B
    apart) fall in the same 4 banks, an 8-way conflict."""
    addrs = [(8 * 0 + r) * 128 + 0 for r in range(8)]
    assert len({(a // 4 + w) % 32 for a in addrs for w in range(4)}) == 4


@pytest.mark.parametrize("expr", [
    # bias_lane: the lane's row of its warp's 16 and its swizzled chunk
    "((warp % 4) * 16 + 8 * (mi % 2) + i) * 128",
    "(((mi / 2) ^ i) << 4)",
    # pair_address: the octet pair's chunk by xor, the second box by offset
    "(bias_tile ^ ((j % 8) << 4)) + (j / 8) * kBiasBoxBytes",
    # swizzled_tile: 64-key boxes with the 128-byte swizzle
    "constexpr int kBiasBoxKeys = 64;",
    "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,\n"
    "            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B",
])
def test_the_model_mirrors_the_kernel_source(expr):
    """The formulas above are the header's: a change to one of them there
    must be carried into this model."""
    assert expr in HEADER.read_text(), expr
