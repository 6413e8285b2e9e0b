"""Convert a reference (PyTorch DeepCLR) checkpoint or a JAX package weights
file into this package's ``weights.pt``:

    python -m deepclr_tpu_torch.convert_weights WEIGHTS MODEL_CONFIG.yaml OUT.pt

WEIGHTS is a reference ``weights.tar`` / ``ckpt.tar`` or a JAX
``weights.msgpack`` / ``ckpt_*.msgpack``.  The weights are loaded into a
model built from MODEL_CONFIG.yaml on the CPU, so every name and shape is
checked against it; OUT.pt then loads with ``models.load_weights``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

__all__ = ["convert", "main"]


def convert(weights: str, model_config: str, output: str) -> None:
    from .config import load_model_config
    from .models import build_model, load_weights, save_weights

    model = build_model(load_model_config(model_config, weights), device="cpu")
    save_weights(output, load_weights(weights, model))


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Convert DeepCLR weights to this package's weights.pt.")
    parser.add_argument("weights", type=str, help="reference weights.tar / ckpt.tar or JAX *.msgpack")
    parser.add_argument("model_config", type=str, help="model_config.yaml")
    parser.add_argument("output", type=str, help="output weights.pt")
    args = parser.parse_args(argv)
    convert(args.weights, args.model_config, args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
