"""Inference latency with an untrained model, batch 1.

    python -m deepclr_tpu_torch.timing CONFIG.yaml [--sequential] [--upload_dtype float32|uint16]

The model is built from the YAML's model section and ``seed`` on its
``device`` (``tpu`` and ``cuda`` mean the CUDA card, ``cpu`` the CPU), and
runs on the clouds of its validation data (``data.validation``, through
``make_data_loader(cfg, is_train=False, batch_size=1)``).  Pass 1 prints
the wall milliseconds of each prediction through ``ModelInferenceHelper``,
one per line, each ending in the fetch of the prediction.  Pass 2 repeats
the predictions on clouds already padded and on the device (one pair of
lookahead), timed with CUDA events on the card and the host clock on the
CPU.  Then three ``#`` summary lines: the wall ms a frame, the compute-only
ms a frame, and their difference (upload, pad and dispatch).  The first
frame of each pass is left out of the summary.
"""
from __future__ import annotations

import argparse
import collections
import time
from typing import Dict, List

import numpy as np
import torch

from .config import Mode, load_config
from .data import make_data_loader
from .models import ModelInferenceHelper, build_model, pad_cloud
from .utils.logging import create_logger

__all__ = ["main", "timing"]


def _collect_clouds(cfg):
    data_loader = make_data_loader(cfg, is_train=False, batch_size=1)
    if data_loader is None:
        raise RuntimeError("config has no data.validation entry: timing needs clouds to run on (use a config "
                           "with a data section, e.g. the one written into a training run directory)")
    pairs = []
    for batch in data_loader:
        template = batch["template"][0][batch["template_mask"][0]]
        source = batch["source"][0][batch["source_mask"][0]]
        pairs.append((template, source))
    return pairs


def timing(cfg, sequential: bool, upload_dtype: str = "float32") -> Dict[str, List[float]]:
    """Both passes over the validation clouds of ``cfg`` (a ``Config``);
    prints the per-frame wall ms and the summary lines and returns
    {"wall_ms": [...], "compute_ms": [...]}."""
    model = build_model(cfg.model, device=cfg.device, seed=cfg.seed)
    device = next(model.parameters()).device
    num_points = cfg.data_loader.num_points or 16384
    helper = ModelInferenceHelper(model, is_sequential=sequential, num_points=num_points,
                                  upload_dtype=upload_dtype)
    pairs = _collect_clouds(cfg)

    # pass 1: wall ms a prediction, ending in its fetch (predict returns host arrays)
    wall_ms = []
    for template, source in pairs:
        t0 = time.perf_counter()
        if sequential:
            if not helper.has_state():
                helper.predict(template)
            helper.predict(source)
        else:
            helper.predict(source, template)
        ms = (time.perf_counter() - t0) * 1000.0
        wall_ms.append(ms)
        print(ms, flush=True)

    # pass 2: the same predictions on padded clouds already on the device
    rng = np.random.default_rng(0)
    cuda = device.type == "cuda"

    def upload(pair):
        out = []
        for cloud in pair:
            pts, mask = pad_cloud(cloud, num_points, rng)
            out += [torch.from_numpy(pts[None]).to(device), torch.from_numpy(mask[None]).to(device)]
        if cuda:
            torch.cuda.synchronize()  # the transfer ends before the timed window
        return out

    def clock(fn):
        if not cuda:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1000.0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    comp_ms = []
    with torch.inference_mode():
        # a lookahead of one pair: uploading the whole set at once would grow
        # device memory with the sequence
        pending = collections.deque([upload(pairs[0])])
        pt, mt, ps, ms_ = pending[0]
        f0 = model.encode(pt, mt)  # warm-up on the resident shapes
        (model.encode_register(f0, ps, ms_)[0] if sequential else model.register(f0, f0)).cpu()
        state = None
        for i in range(len(pairs)):
            if i + 1 < len(pairs):
                pending.append(upload(pairs[i + 1]))
            pt, mt, ps, ms_ = pending.popleft()

            def step():
                nonlocal state
                if sequential:
                    if state is None:
                        state = model.encode(pt, mt)
                    y, state = model.encode_register(state, ps, ms_)
                else:
                    y = model.register(model.encode(pt, mt), model.encode(ps, ms_))
                return y

            comp_ms.append(clock(step))

    if wall_ms:
        w = np.asarray(wall_ms[1:] or wall_ms)
        c = np.asarray(comp_ms[1:] or comp_ms)
        print(f"# wall ms/frame: mean {w.mean():.2f} median {np.median(w):.2f} (upload_dtype={upload_dtype})")
        print(f"# compute-only ms/frame (device-resident input): mean {c.mean():.2f} median {np.median(c):.2f}")
        print(f"# upload+pad+dispatch tax: {w.mean() - c.mean():.2f} ms", flush=True)
    return {"wall_ms": wall_ms, "compute_ms": comp_ms}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Test inference time with untrained model.")
    parser.add_argument("config", type=str, help="training configuration (*.yaml)")
    parser.add_argument("--sequential", action="store_true", help="activate sequential inference")
    parser.add_argument("--upload_dtype", type=str, default="float32", choices=["float32", "uint16"],
                        help="host->device cloud upload format")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, Mode.TEST)
    logger = create_logger(name="timing")
    logger.info("Timing with config loaded")
    timing(cfg, args.sequential, args.upload_dtype)


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted by user")
