"""Offline checkpoint-conversion CLI: HF/torch weights -> the port's checkpoint.

Counterpart of the JAX package's ``convert/__main__.py``, with its flags,
choices and errors.  Run once offline, then point the service at the output
with ``MODEL_PATH``:

    python -m mlmicroservicetemplate_tpu_torch.convert \\
        --model gpt2 --input pytorch_model.bin --output /ckpt/gpt2

Input formats: .safetensors / .npz / .bin / .pt / .pth
(``models/checkpoint.load_state_dict``).  Output: a directory with the
port's own parameters (``params.npz``, the port modules' state-dict names)
and ``port_checkpoint.json`` naming the model and its layer count
(``models/checkpoint.save_checkpoint``); the service loads it with no HF
mapping.  The widths are the model's standard ones; llama's as
``LLAMA_CONFIG`` sets them, as the service reads that variable.
"""

from __future__ import annotations

import argparse
import sys

CONVERTERS = {
    "resnet50": "resnet_state_to_pytree",
    "bert-base": "bert_state_to_pytree",
    "t5-small": "t5_state_to_pytree",
    "gpt2": "gpt2_state_to_pytree",
    "llama": "llama_state_to_pytree",
}
# The JAX layout -> the port's parameters (ResNet's map gives the port's
# names already).
CARRY = {
    "resnet50": None,
    "bert-base": "bert_params_from_jax",
    "t5-small": "t5_params_from_jax",
    "gpt2": "gpt_params_from_jax",
    "llama": "llama_params_from_jax",
}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True, choices=sorted(CONVERTERS))
    p.add_argument("--input", required=True, help="state-dict file (.safetensors/.npz/.bin/.pt)")
    p.add_argument("--output", required=True, help="checkpoint directory")
    p.add_argument(
        "--num-layers", type=int, default=None,
        help="override transformer layer count (default: the model's standard depth)",
    )
    args = p.parse_args(argv)

    from ..models.checkpoint import load_state_dict, save_checkpoint
    from ..models.registry import param_config
    from . import hf_maps, jax_params

    convert = getattr(hf_maps, CONVERTERS[args.model])
    state = load_state_dict(args.input)
    kwargs = {}
    if args.num_layers is not None:
        if args.model == "resnet50":
            p.error("--num-layers applies to transformer models, not resnet50")
        kwargs["n_layers"] = args.num_layers
    pytree = convert(state, **kwargs)
    cfg = param_config(args.model, args.num_layers)
    carry = CARRY[args.model]
    params = pytree if carry is None else getattr(jax_params, carry)(pytree, cfg)
    save_checkpoint(args.output, args.model, getattr(cfg, "num_layers", None), params)
    print(f"converted {args.input} -> {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
