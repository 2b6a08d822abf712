"""The port's SentencePiece tokenizer against the JAX package's, on the
piece tables of ``tests/test_sentencepiece.py``.

- Unigram (Viterbi, byte fallback, <unk>) and SPM-BPE: ids, masks and
  decoded text identical to the JAX tokenizer's on one corpus, with and
  without a trailing EOS or a leading BOS.
- A ``spiece.model`` written by either package loads in the other with
  the same pieces, scores, types and algorithm.
- ``build_tokenizer`` routes ``.model``, ``.tsv`` and ``.vocab`` to
  SentencePiece (EOS with ``for_t5``) as the JAX factory does; llama's
  builder loads them with a BOS and no EOS.
"""

import json

import numpy as np
import pytest
from test_sentencepiece import _bpe_fixture, _pieces

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.models import sentencepiece as jax_sp
from mlmicroservicetemplate_tpu.models import tokenizer as jax_tok
from mlmicroservicetemplate_tpu_torch.models import sentencepiece as port_sp
from mlmicroservicetemplate_tpu_torch.models import tokenizer as port_tok
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.serve import build_service

CORPUS = [
    "hello world", "the quick hello world", "  hello   \t world  ", "héllo wörld",
    "quick! the, world?", "東京 hello", "emoji 🙂 world", "", " ", "helloworld",
    "the quell held", "xyz qrs",
]


def _same(port, ref, text: str, max_len: int) -> None:
    got, want = port.encode(text, max_len), ref.encode(text, max_len)
    np.testing.assert_array_equal(got[0], want[0], err_msg=repr(text))
    np.testing.assert_array_equal(got[1], want[1], err_msg=repr(text))
    assert port.decode(got[0]) == ref.decode(want[0]), repr(text)


@pytest.mark.parametrize("with_bytes", [True, False], ids=["byte-fallback", "unk"])
@pytest.mark.parametrize("add_eos,add_bos", [(True, False), (False, False), (False, True)])
def test_unigram_ids_match_jax(with_bytes, add_eos, add_bos):
    pieces = _pieces(with_bytes)
    port = port_sp.SentencePieceTokenizer(pieces, add_eos=add_eos, add_bos=add_bos)
    ref = jax_sp.SentencePieceTokenizer(pieces, add_eos=add_eos, add_bos=add_bos)
    assert (port.pad_id, port.eos_id, port.unk_id, port.bos_id, port.vocab_size) == \
        (ref.pad_id, ref.eos_id, ref.unk_id, ref.bos_id, ref.vocab_size)
    for text in CORPUS:
        for max_len in (4, 64):
            _same(port, ref, text, max_len)


@pytest.mark.parametrize("add_bos", [False, True])
def test_bpe_ids_match_jax(add_bos):
    pieces, _, _ = _bpe_fixture()
    port = port_sp.SentencePieceTokenizer(pieces, add_eos=False, add_bos=add_bos,
                                          algorithm="bpe")
    ref = jax_sp.SentencePieceTokenizer(pieces, add_eos=False, add_bos=add_bos,
                                        algorithm="bpe")
    for text in CORPUS + ["hello the world quick", "held", "quell"]:
        for max_len in (3, 32):
            _same(port, ref, text, max_len)


@pytest.mark.parametrize("writer,reader", [(port_sp, jax_sp), (jax_sp, port_sp)],
                         ids=["port-writes", "jax-writes"])
@pytest.mark.parametrize("bpe", [False, True], ids=["unigram", "bpe"])
def test_model_files_cross_load(tmp_path, writer, reader, bpe):
    pieces = _bpe_fixture()[0] if bpe else _pieces()
    path = str(tmp_path / "spiece.model")
    writer.write_spiece_model(path, pieces, model_type=writer.MODEL_BPE if bpe else None)
    loaded, model_type = reader.load_spiece_model_ex(path)
    assert [(p, t) for p, _, t in loaded] == [(p, t) for p, _, t in pieces]
    np.testing.assert_allclose([s for _, s, _ in loaded], [s for _, s, _ in pieces],
                               rtol=1e-6)
    assert model_type == (reader.MODEL_BPE if bpe else reader.MODEL_UNIGRAM)
    got = port_sp.load_sentencepiece(path, add_eos=not bpe)
    want = jax_sp.load_sentencepiece(path, add_eos=not bpe)
    assert got.algorithm == want.algorithm == ("bpe" if bpe else "unigram")
    for text in CORPUS:
        _same(got, want, text, 32)


@pytest.mark.parametrize("suffix", [".model", ".tsv", ".vocab"])
@pytest.mark.parametrize("for_t5", [True, False])
def test_factory_routes_sentencepiece_files(tmp_path, suffix, for_t5):
    pieces = _pieces()
    path = str(tmp_path / f"spiece{suffix}")
    if suffix == ".model":
        port_sp.write_spiece_model(path, pieces)
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.writelines(f"{p}\t{s}\n" for p, s, _ in pieces)
    port = port_tok.build_tokenizer(path, for_t5=for_t5)
    ref = jax_tok.build_tokenizer(path, for_t5=for_t5)
    assert isinstance(port, port_sp.SentencePieceTokenizer)
    assert port.add_eos is ref.add_eos is for_t5
    for text in CORPUS:
        _same(port, ref, text, 24)


def test_llama_loads_sentencepiece_with_bos_and_no_eos(tmp_path):
    """Llama's builder takes a SentencePiece file with a leading <s> and
    no trailing </s>, as the JAX builder does, and its model's eos/pad
    are the tokenizer's."""
    pieces, _, _ = _bpe_fixture()
    path = str(tmp_path / "tokenizer.model")
    port_sp.write_spiece_model(path, pieces, model_type=port_sp.MODEL_BPE)
    small = dict(vocab_size=64, d_model=64, num_heads=2, num_kv_heads=1, num_layers=1,
                 d_ff=128, max_position=128)
    _, bundle, _, batcher = build_service({
        "MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "TOKENIZER_PATH": path,
        "LLAMA_CONFIG": json.dumps(small), "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "8"})
    ref = jax_sp.load_sentencepiece(path, add_eos=False, add_bos=True)
    tok = bundle.tokenizer
    assert (tok.add_eos, tok.add_bos, tok.algorithm) == (False, True, "bpe")
    assert (bundle.cfg.eos_id, bundle.cfg.pad_id) == (tok.eos_id, tok.pad_id)
    feats = bundle.preprocess(RawItem(text="hello world"))
    want = ref.encode("hello world", bundle.max_prompt_len)[0]
    np.testing.assert_array_equal(feats["input_ids"], want[: int(feats["length"])])
    assert int(feats["input_ids"][0]) == tok.bos_id
