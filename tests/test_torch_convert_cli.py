"""The port's converter CLI (``python -m mlmicroservicetemplate_tpu_torch.convert``)
against the JAX package's, on seeded random HF state dicts at two layers:

- for gpt2 and llama, the port's checkpoint, loaded, equals the JAX CLI's
  orbax output restored by the JAX loader and carried across by
  ``convert/jax_params.py``; a ``.bin`` input gives the ``.npz``'s;
- ``MODEL_PATH`` at the port's checkpoint builds the model ``MODEL_PATH`` at
  the HF ``.npz`` builds (same parameters, same greedy tokens);
- the flags, choices and errors are the reference's (``--num-layers`` on
  resnet50 is an error); a directory that is not the port's checkpoint is
  refused, as is a checkpoint of another model or layer count.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_gpt import DIMS, small_gpt2
from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from test_torch_llama import _hf_state as llama_hf_state

import jax

from mlmicroservicetemplate_tpu.convert.__main__ import main as jax_main
from mlmicroservicetemplate_tpu.models.checkpoint import load_pytree as jax_load_pytree
from mlmicroservicetemplate_tpu_torch.convert import jax_params
from mlmicroservicetemplate_tpu_torch.convert.__main__ import main as port_main
from mlmicroservicetemplate_tpu_torch.models import registry
from mlmicroservicetemplate_tpu_torch.models.checkpoint import (
    is_checkpoint_dir,
    load_checkpoint,
)
from mlmicroservicetemplate_tpu_torch.utils.config import load_config

LLAMA = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)


def gpt2_hf_state(rng) -> dict[str, np.ndarray]:
    """A random HF GPT-2 state dict at ``DIMS`` (Conv1D weights [in, out])."""
    d, f, v, p = DIMS["d_model"], DIMS["d_ff"], DIMS["vocab_size"], DIMS["max_position"]

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    state = {"transformer.wte.weight": w(v, d), "transformer.wpe.weight": w(p, d),
             "transformer.ln_f.weight": 1.0 + w(d), "transformer.ln_f.bias": w(d)}
    for i in range(DIMS["num_layers"]):
        b = f"transformer.h.{i}"
        for name in ("ln_1", "ln_2"):
            state[f"{b}.{name}.weight"] = 1.0 + w(d)
            state[f"{b}.{name}.bias"] = w(d)
        for name, (n_in, n_out) in (("attn.c_attn", (d, 3 * d)), ("attn.c_proj", (d, d)),
                                    ("mlp.c_fc", (d, f)), ("mlp.c_proj", (f, d))):
            state[f"{b}.{name}.weight"] = w(n_in, n_out)
            state[f"{b}.{name}.bias"] = w(n_out)
    return state


@pytest.fixture
def small(monkeypatch):
    """Both packages at the tests' widths: GPT-2 at ``DIMS``, llama through
    ``LLAMA_CONFIG``."""
    monkeypatch.setenv("LLAMA_CONFIG", json.dumps(LLAMA))
    with small_gpt2():
        yield


def _hf(model: str) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    if model == "gpt2":
        return gpt2_hf_state(rng)
    return llama_hf_state(rng, 2, LLAMA["d_model"], 128, LLAMA["d_ff"], LLAMA["vocab_size"])


CARRY = {"gpt2": jax_params.gpt_params_from_jax, "llama": jax_params.llama_params_from_jax}


@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_the_cli_output_equals_the_jax_clis(model, tmp_path, small, capsys):
    src = tmp_path / "hf.npz"
    np.savez(src, **_hf(model))
    args = ["--model", model, "--input", str(src), "--num-layers", "2"]
    port_main(args + ["--output", str(tmp_path / "port")])
    jax_main(args + ["--output", str(tmp_path / "jax")])
    err = capsys.readouterr().err
    assert f"converted {src} -> {tmp_path / 'port'}" in err
    assert f"converted {src} -> {tmp_path / 'jax'}" in err
    assert is_checkpoint_dir(str(tmp_path / "port"))
    assert not is_checkpoint_dir(str(tmp_path / "jax"))
    restored = jax.tree.map(np.asarray, jax_load_pytree(str(tmp_path / "jax"), None))
    want = CARRY[model](restored, registry.param_config(model, 2))
    got = load_checkpoint(str(tmp_path / "port"), model, 2)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), value.numpy(), err_msg=name)
    meta = json.loads((tmp_path / "port" / "port_checkpoint.json").read_text())
    assert meta == {"format": 1, "model": model, "num_layers": 2, "params": "params.npz"}
    # A torch .bin input converts to the same checkpoint.
    torch.save({k: torch.from_numpy(v) for k, v in _hf(model).items()}, tmp_path / "hf.bin")
    port_main(["--model", model, "--input", str(tmp_path / "hf.bin"), "--num-layers", "2",
               "--output", str(tmp_path / "port_bin")])
    from_bin = load_checkpoint(str(tmp_path / "port_bin"), model, 2)
    assert all(torch.equal(from_bin[k], got[k]) for k in got)


def _bundle(model: str, path: str):
    env = {"DEVICE": "cpu", "MODEL_NAME": model, "MODEL_PATH": path, "WARMUP": "0",
           "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "16"}
    if model == "llama":
        env["LLAMA_CONFIG"] = json.dumps(LLAMA)
    return registry.build_model(load_config(env))


@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_model_path_at_the_checkpoint_serves_the_npz_weights(model, tmp_path, small):
    src = tmp_path / "hf.npz"
    np.savez(src, **_hf(model))
    port_main(["--model", model, "--input", str(src), "--output", str(tmp_path / "ckpt"),
               "--num-layers", "2"])
    a, b = _bundle(model, str(tmp_path / "ckpt")), _bundle(model, str(src))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    ids = torch.tensor([[5, 6, 7, 8]])
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        la = a.init_state(ids, mask, 4).tokens
        lb = b.init_state(ids, mask, 4).tokens
    assert torch.equal(la, lb)


@pytest.mark.parametrize("argv", [
    ["--model", "resnet50", "--input", "x.npz", "--output", "out", "--num-layers", "2"],
    ["--model", "bogus", "--input", "x.npz", "--output", "out"],
    ["--model", "gpt2", "--output", "out"],
])
def test_flags_and_errors_are_the_references(argv, tmp_path, capsys):
    np.savez(tmp_path / "x.npz", a=np.zeros(1, np.float32))
    argv = [str(tmp_path / a) if a in ("x.npz", "out") else a for a in argv]
    codes, errs = [], []
    for main in (jax_main, port_main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        codes.append(e.value.code)
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert codes == [2, 2]
    assert errs[0].split(": ", 1)[1] == errs[1].split(": ", 1)[1]
    if "resnet50" in argv:
        assert "--num-layers applies to transformer models, not resnet50" in errs[1]


def test_other_directories_and_checkpoints_are_refused(tmp_path, small):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="is a directory; the port loads HF state dicts"):
        _bundle("gpt2", str(tmp_path / "orbax"))
    src = tmp_path / "hf.npz"
    np.savez(src, **_hf("gpt2"))
    port_main(["--model", "gpt2", "--input", str(src), "--output", str(tmp_path / "g"),
               "--num-layers", "2"])
    with pytest.raises(ValueError, match="holds a 'gpt2' checkpoint; MODEL_NAME is 'llama'"):
        _bundle("llama", str(tmp_path / "g"))
    with pytest.raises(ValueError, match="holds 2 layers; the gpt2 being built has 3"):
        load_checkpoint(str(tmp_path / "g"), "gpt2", 3)
