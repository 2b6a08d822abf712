"""Speculative decoding (``models/spec.py``) of the port against the JAX
package's, f32 on the CPU, on the same weights and seeded numpy inputs at
small widths: the n-gram drafts integer-equal (the fallback to shorter n
included), the verify windows' logits of gpt2, llama (dense and int8 KV)
and t5 within 1e-4 with windows that run past the cache's end, the caches
those windows write, whole chunks of verify rounds (outputs, counts and
states) equal, the rejection sampler's threefry draws bit-equal, and the
spec tokens equal to non-speculative greedy decoding's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.models import gpt as jax_gpt
from mlmicroservicetemplate_tpu.models import llama as jax_llama
from mlmicroservicetemplate_tpu.models import sampling as jax_sampling
from mlmicroservicetemplate_tpu.models import spec as jax_spec
from mlmicroservicetemplate_tpu.models import t5 as jax_t5
from mlmicroservicetemplate_tpu_torch.convert.jax_params import (
    gpt_params_from_jax,
    llama_params_from_jax,
    t5_params_from_jax,
)
from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
from mlmicroservicetemplate_tpu_torch.models import llama as port_llama
from mlmicroservicetemplate_tpu_torch.models import sampling as port_sampling
from mlmicroservicetemplate_tpu_torch.models import spec as port_spec
from mlmicroservicetemplate_tpu_torch.models import t5 as port_t5

TOL = 1e-4  # f32 logits against the JAX forward
GPT = dict(vocab_size=19, d_model=32, num_heads=2, num_layers=2, d_ff=64, max_position=128,
           eos_id=2, pad_id=0)
LLAMA = dict(vocab_size=19, d_model=32, num_heads=4, num_kv_heads=2, num_layers=2, d_ff=64,
             max_position=128, eos_id=2, pad_id=0)
T5 = dict(vocab_size=64, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)
FAMILIES = ["gpt2", "llama", "llama-int8", "t5"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Family:
    """One family's JAX and port sides on the same weights."""

    def __init__(self, name: str, seed: int = 0):
        self.name = name
        key = jax.random.PRNGKey(seed)
        if name == "t5":
            self.jmod, self.pmod = jax_t5, port_t5
            self.jcfg = jax_t5.T5Config(**T5)
            params = jax_t5.init_params(key, cfg=self.jcfg)
            # A tied random head argmax-locks: untie it.
            params["lm_head"] = {"kernel": jax.random.normal(
                jax.random.PRNGKey(99), (T5["d_model"], T5["vocab_size"]))}
            self.params = jax.tree.map(np.asarray, params)
            self.cfg = port_t5.T5Config(**T5)
            state = t5_params_from_jax(self.params, self.cfg)
        elif name == "gpt2":
            self.jmod, self.pmod = jax_gpt, port_gpt
            self.jcfg = jax_gpt.GPTConfig(**GPT)
            self.params = jax.tree.map(np.asarray, jax_gpt.init_params(key, self.jcfg))
            self.cfg = port_gpt.GPTConfig(**GPT)
            state = gpt_params_from_jax(self.params, self.cfg)
        else:
            quant = name == "llama-int8"
            self.jmod, self.pmod = jax_llama, port_llama
            self.jcfg = jax_llama.LlamaConfig(**LLAMA, kv_quant=quant)
            self.params = jax.tree.map(np.asarray, jax_llama.init_params(key, self.jcfg))
            self.cfg = port_llama.LlamaConfig(**LLAMA, kv_quant=quant)
            state = llama_params_from_jax(self.params, self.cfg)
        self.model = self.pmod.build_model(self.cfg, state, torch.device("cpu"), torch.float32)
        self.vocab = self.cfg.vocab_size

    def jax_multi(self, p, st, toks):
        return self.jmod.multi_step(p, self.jcfg, st, toks)

    def port_multi(self, st, toks):
        return self.pmod.multi_step(self.model, st, toks)

    def states(self, ids, mask, max_len, sample=None):
        """(JAX spec state, port spec state) after the prefill."""
        jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
        tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
        jsp = None if sample is None else jax_sampling.make_params(*sample)
        psp = None if sample is None else port_sampling.make_params(*sample)
        if self.name == "t5":
            enc = jax_t5.encode(self.params, self.jcfg, jids, jmask)
            js = jax_t5.init_decode_state(self.params, self.jcfg, enc, jmask, max_len,
                                          sample=jsp)
            penc = port_t5.encode(self.model, tids, tmask)
            ps = port_t5.init_decode_state(self.model, penc, tmask, max_len, sample=psp)
            return (jax_t5.init_spec_state(js, jids, jmask),
                    port_t5.init_spec_state(ps, tids, tmask))
        js = self.jmod.init_decode_state(self.params, self.jcfg, jids, jmask, max_len,
                                         sample=jsp)
        ps = self.pmod.init_decode_state(self.model, tids, tmask, max_len, sample=psp)
        return (jax_spec.init_history(js, jids, jmask, 0),
                port_spec.init_history(ps, tids, tmask, 0))

    def greedy(self, ids, mask, max_len):
        return self.pmod.greedy_generate(self.model, torch.from_numpy(ids),
                                         torch.from_numpy(mask), max_len).numpy()


@pytest.fixture(scope="module")
def families():
    return {name: Family(name) for name in FAMILIES}


def _prompts(vocab: int, lens, seed: int = 0):
    """Right-padded prompts of tiled short cycles (real n-gram matches),
    ids clear of pad and eos."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), max(lens)), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        cycle = rng.integers(3, vocab, rng.integers(2, 5))
        ids[i, :n] = np.tile(cycle, n // len(cycle) + 1)[:n]
        mask[i, :n] = 1
    return ids, mask


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cache_entries(state):
    out = []
    for c in list(state.cache_k) + list(state.cache_v):
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


# ---------------------------------------------------------------------------
# drafting


def test_draft_ngram_semantics():
    """The JAX test's cases: the continuation of the most recent earlier
    match, -1 without one, -1 regions never matching."""
    hist = torch.tensor([[7, 5, 3, 9, 7, 5, 8, 2, 7, 5]])
    w = torch.tensor([9])
    assert port_spec.draft_ngram(hist, w, 3, 2).tolist() == [[8, 2, 7]]
    assert port_spec.draft_ngram(hist, w, 2, 1).tolist() == [[8, 2]]
    hist2 = torch.arange(1, 11)[None]
    assert (port_spec.draft_ngram(hist2, w, 3, 2) == -1).all()
    hist3 = torch.tensor([[-1, -1, 4, 6, 4, 6, -1, -1, -1, -1]])
    assert port_spec.draft_ngram(hist3, torch.tensor([5]), 2, 2).tolist() == [[4, 6]]


@pytest.mark.parametrize("ngram_n", [1, 2, 3, 4])
@pytest.mark.parametrize("spec_k", [1, 3, 8])
def test_draft_ngram_matches_jax(ngram_n, spec_k):
    """Random histories over a small alphabet (many matches, and rows
    where only a shorter n matches), -1 holes, write positions anywhere."""
    rng = np.random.default_rng(ngram_n * 10 + spec_k)
    hist = rng.integers(0, 4, (16, 40)).astype(np.int32)
    hist[rng.random(hist.shape) < 0.1] = -1
    w = rng.integers(0, 40, 16).astype(np.int32)
    want = np.asarray(jax_spec.draft_ngram(jnp.asarray(hist), jnp.asarray(w), spec_k, ngram_n))
    got = port_spec.draft_ngram(torch.from_numpy(hist).long(), torch.from_numpy(w), spec_k,
                                ngram_n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_draft_ngram_fallback_to_shorter_n():
    """The trailing trigram never occurred, its bigram did: n = 3 falls
    back to the bigram's continuation (the JAX test's case)."""
    hist = np.array([[5, 6, 7, 8, 1, 6, 7, -1]], np.int32)
    w = np.array([6], np.int32)
    want = np.asarray(jax_spec.draft_ngram(jnp.asarray(hist), jnp.asarray(w), 2, 3))
    got = port_spec.draft_ngram(torch.from_numpy(hist).long(), torch.from_numpy(w), 2, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [[8, 1]]


# ---------------------------------------------------------------------------
# verify windows


@pytest.mark.parametrize("name", FAMILIES)
def test_multi_step_logits_and_writes_match_jax(families, name):
    """One verify window per row at the row's own position, row 0's
    straddling the cache's end (its writes past it dropped) and row 1's
    wholly inside: logits within 1e-4 and every cache entry after the
    writes equal (int8 payloads exactly)."""
    fam = families[name]
    ids, mask = _prompts(fam.vocab, [7, 5], seed=1)
    jss, pss = fam.states(ids, mask, max_len=8)
    total = jss.base.key_valid.shape[1]
    widx = np.array([total - 2, 5], np.int32)
    jbase = jss.base._replace(write_idx=jnp.asarray(widx))
    pss.base.write_idx.copy_(torch.from_numpy(widx).long())
    if name == "t5":
        jbase = jbase._replace(pos=jnp.asarray(widx))
        pss.base.pos.copy_(torch.from_numpy(widx).long())
    toks = np.random.default_rng(2).integers(3, fam.vocab, (2, 5)).astype(np.int32)
    jk, jv, jlogits = fam.jax_multi(fam.params, jbase, jnp.asarray(toks))
    plogits = fam.port_multi(pss.base, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(plogits), np.asarray(jlogits), atol=TOL, rtol=0)
    want = _cache_entries(jbase._replace(cache_k=jk, cache_v=jv))
    for got, ref in zip(_cache_entries(pss.base), want):
        if got.dtype == torch.int8:
            np.testing.assert_array_equal(_np(got), np.asarray(ref))
        else:
            np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5, rtol=0)


def _jax_chunk(fam, jss, n_verify, spec_k, ngram_n=2, sample=False):
    return jax_spec.spec_chunk(fam.params, jss, n_verify, spec_k, ngram_n, fam.jax_multi,
                               fam.cfg.eos_id, fam.cfg.pad_id, sample)


def _port_chunk(fam, pss, n_verify, spec_k, ngram_n=2, sample=False):
    return port_spec.spec_chunk(pss, n_verify, spec_k, ngram_n, fam.port_multi,
                                fam.cfg.eos_id, fam.cfg.pad_id, sample)


def _assert_states_equal(jss, pss):
    jb, pb = jss.base, pss.base
    for field in ("write_idx", "pos", "last_token", "done", "tokens", "key_valid"):
        np.testing.assert_array_equal(_np(getattr(pb, field)), np.asarray(getattr(jb, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(_np(pss.history), np.asarray(jss.history))
    np.testing.assert_array_equal(_np(pb.sample.rng), np.asarray(jb.sample.rng))


@pytest.mark.parametrize("name", FAMILIES)
def test_spec_chunk_matches_jax(families, name):
    """Chunks of verify rounds over a ragged greedy batch until the cache
    runs out: outputs, counts and every state field equal, round after
    round, the last windows past the cache's end."""
    fam = families[name]
    ids, mask = _prompts(fam.vocab, [9, 4, 6], seed=3)
    jss, pss = fam.states(ids, mask, max_len=12)
    for _ in range(4):
        jss, jout, jns = _jax_chunk(fam, jss, 2, 4)
        pss, pout, pns = _port_chunk(fam, pss, 2, 4)
        np.testing.assert_array_equal(pns.numpy(), np.asarray(jns))
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        _assert_states_equal(jss, pss)


@pytest.mark.parametrize("name", ["gpt2", "llama", "t5"])
def test_sampled_spec_chunk_matches_jax(families, name):
    """Seeded sampled rows beside a greedy one (top-k and top-p rows
    too): the same emissions, counts and rng chains, round after round."""
    fam = families[name]
    ids, mask = _prompts(fam.vocab, [8, 8, 5, 6], seed=4)
    sample = (np.array([7, 11, 0, 1234567], np.uint64),
              np.array([0.9, 1.3, 0.0, 0.7], np.float32),
              np.array([0, 5, 0, 0], np.int32), np.array([1.0, 1.0, 1.0, 0.8], np.float32))
    jss, pss = fam.states(ids, mask, max_len=16, sample=sample)
    for _ in range(3):
        jss, jout, jns = _jax_chunk(fam, jss, 2, 3, sample=True)
        pss, pout, pns = _port_chunk(fam, pss, 2, 3, sample=True)
        np.testing.assert_array_equal(pns.numpy(), np.asarray(jns))
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        _assert_states_equal(jss, pss)


# ---------------------------------------------------------------------------
# the rejection sampler's draws


@pytest.mark.parametrize("data", [0, 1, 5, 2**31 + 3])
def test_fold_in_uniform_categorical_are_jax_bits(data):
    rng = np.random.default_rng(data % 1000)
    seeds = rng.integers(0, 2**32, 6, dtype=np.uint64)
    keys = port_sampling.make_params(seeds, np.ones(6, np.float32), np.zeros(6, np.int32),
                                     np.ones(6, np.float32)).rng
    jkeys = [jax.random.PRNGKey(int(s)) for s in seeds]
    got = port_sampling.fold_in(keys, data)
    want = np.stack([np.asarray(jax.random.fold_in(k, data)) for k in jkeys])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    u = port_sampling.uniform(got, 9)
    uw = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, data), (9,)))
                   for k in jkeys])
    np.testing.assert_array_equal(u.numpy(), uw)
    logits = rng.normal(0.0, 2.0, (6, 37)).astype(np.float32)
    c = port_sampling.categorical(got, torch.from_numpy(logits))
    cw = [int(jax.random.categorical(jax.random.fold_in(k, data), jnp.asarray(lg)))
          for k, lg in zip(jkeys, logits)]
    assert c.tolist() == cw


def _emission_inputs(n, spec_k, v, seed, top_k=0, top_p=1.0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 1.5, (n, spec_k + 1, v)).astype(np.float32)
    draft = rng.integers(-1, v, (n, spec_k)).astype(np.int32)
    args = (np.arange(seed, seed + n, dtype=np.uint64), np.full(n, 0.8, np.float32),
            np.full(n, top_k, np.int32), np.full(n, top_p, np.float32))
    return logits, draft, args


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.7)])
def test_sampled_emission_matches_jax(top_k, top_p):
    """Candidates, accepted counts and next keys of 256 seeded rows equal
    the JAX function's (the rows' filters applied)."""
    logits, draft, args = _emission_inputs(256, 4, 11, seed=5 + top_k, top_k=top_k,
                                           top_p=top_p)
    jc, jm, jr = jax_spec._sampled_emission(jnp.asarray(logits), jnp.asarray(draft),
                                            jax_sampling.make_params(*args), 4)
    pc, pm, pr = port_spec._sampled_emission(torch.from_numpy(logits),
                                             torch.from_numpy(draft).long(),
                                             port_sampling.make_params(*args), 4)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr).astype(np.int64))


def test_sampled_emission_distribution():
    """The JAX test's analytic check: P(m >= 1) = p0(d1), the first
    token's marginal is p0, a rejected draft is never emitted first."""
    v, spec_k, n = 5, 2, 4096
    row = np.random.default_rng(0).normal(0.0, 1.5, (spec_k + 1, v)).astype(np.float32)
    logits = torch.from_numpy(np.broadcast_to(row, (n, spec_k + 1, v)).copy())
    d1, d2 = 2, 4
    draft = torch.tensor([[d1, d2]]).expand(n, 2)
    sp = port_sampling.make_params(np.arange(n, dtype=np.uint64), np.ones(n, np.float32),
                                   np.zeros(n, np.int32), np.ones(n, np.float32))
    cand, m, _ = port_spec._sampled_emission(logits, draft, sp, spec_k)
    cand, m = cand.numpy(), m.numpy()
    p = torch.softmax(torch.from_numpy(row), -1).numpy()
    tol = 4.0 * np.sqrt(0.25 / n)
    assert abs((m >= 1).mean() - p[0, d1]) < tol
    assert abs((m >= 2).mean() - p[0, d1] * p[1, d2]) < tol
    first = np.where(m >= 1, d1, cand[:, 0])
    for tok in range(v):
        assert abs((first == tok).mean() - p[0, tok]) < tol
    assert not np.any((m == 0) & (cand[:, 0] == d1))


# ---------------------------------------------------------------------------
# token identity


def _spec_generate(fam, ids, mask, max_len, spec_k=4):
    """Port spec chunks to exhaustion: each row's emitted tokens and the
    rounds run."""
    _, pss = fam.states(ids, mask, max_len)
    emitted = [[] for _ in range(ids.shape[0])]
    rounds = 0
    while True:
        pss, out, ns = _port_chunk(fam, pss, 2, spec_k)
        rounds += 2
        for b in range(ids.shape[0]):
            emitted[b].extend(port_spec.flatten_emitted(out.numpy(), ns.numpy(), b).tolist())
        if all(bool(pss.base.done[b]) or len(emitted[b]) >= max_len
               for b in range(ids.shape[0])):
            return emitted, rounds
        assert rounds < max_len * 4, "the spec loop did not converge"


@pytest.mark.parametrize("name", FAMILIES)
def test_spec_tokens_equal_greedy(families, name):
    """Emission equals non-speculative greedy decoding (ragged batch;
    under the int8 cache the int8 greedy path, JAX ``test_kv_quant.py``'s
    identity), and the cyclic prompts draft real matches: fewer rounds
    than tokens."""
    fam = families[name]
    ids, mask = _prompts(fam.vocab, [7, 12, 5], seed=6)
    max_len = 24
    ref = fam.greedy(ids, mask, max_len)
    emitted, rounds = _spec_generate(fam, ids, mask, max_len)
    for i, got in enumerate(emitted):
        got = got[:max_len]
        assert got == ref[i][:len(got)].tolist(), i
        if len(got) < max_len:
            assert got[-1] == fam.cfg.eos_id
    assert rounds < max(len(e) for e in emitted)


def test_t5_spec_drafts_from_encoder_input(families):
    """T5's history is [encoder ids | decoder tokens]: the last decoder
    token drafts its continuation out of the document (JAX's test)."""
    fam = families["t5"]
    ids = np.array([[10, 11, 12, 13, 14, 15, 16, 17]], np.int32)
    mask = np.ones_like(ids)
    jss, pss = fam.states(ids, mask, max_len=8)
    s_enc = ids.shape[1]
    for ss in (pss,):
        ss.history[0, s_enc] = 12
    jss = jss._replace(history=jss.history.at[0, s_enc].set(12))
    want = jax_spec.draft_ngram(jss.history, jss.base.write_idx + s_enc, 3, 1)
    got = port_spec.draft_ngram(pss.history, pss.base.write_idx + s_enc, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[13, 14, 15]]


def test_write_emitted_drops_past_the_width():
    buf = torch.arange(12).view(2, 6)
    port_spec.write_emitted(buf, torch.tensor([[90, 91, 92], [80, 81, 82]]),
                         torch.tensor([4, 1]), torch.tensor([3, 2]))
    assert buf.tolist() == [[0, 1, 2, 3, 90, 91], [6, 80, 81, 9, 10, 11]]


def test_span_write_keeps_the_last_column_of_a_straddling_window():
    """A window over positions 4..7 of a 6-wide cache: positions 4 and 5
    take the window's rows 0 and 1; the dropped rows 2 and 3 (aimed at
    the last column with its own value) change nothing."""
    dst = torch.zeros(1, 6, 1)
    new = torch.tensor([[[1.0], [2.0], [3.0], [4.0]]])
    port_gpt.span_write(dst, new, torch.tensor([4]))
    assert dst[0, :, 0].tolist() == [0, 0, 0, 0, 1, 2]
    dst2 = torch.full((1, 6, 1), 7.0)
    port_gpt.span_write(dst2, new, torch.tensor([9]))
    assert dst2[0, :, 0].tolist() == [7.0] * 6
