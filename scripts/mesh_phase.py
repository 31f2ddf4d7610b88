#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 15, the device mesh, alone on one CUDA card.

    python3 scripts/mesh_phase.py   # from the root

Builds the libraries of the mesh's paths (flash attention, its backward,
flash decoding, the segment sum), runs
phase 14's three qwen2.5-3b steps on one device (mesh=None: B 2 x S
4,096, bf16, remat) as the comparison for the sharded steps, then
``chip_smoke.mesh_phase``: llama3-8b served through the mesh's step
builders against the one-device steps, granite-moe-3b's prefill through
the MoE's ``shard_map`` branch, qwen2.5-3b's sharded steps, two gloo ranks
on the card (among them the tensor-parallel serve steps, llama3-8b at full
width cut to 2 layers, and the tensor-parallel train jobs, qwen2.5-3b at
full width cut to 2 layers and mamba2-130m whole), and the dry run.
Prints the card's name and power limit first and the phase's launches, the
one-rank mesh's and the two ranks' tensor-parallel serve and train jobs',
as one JSON line last.  Exits nonzero where
phase 15 fails.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one_device_steps(torch, cs, dev) -> dict:
    """Phase 14's first three steps, their rows and the parameters after
    them on the host."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import pipeline as dpipe
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    cfg = get_config(cs.TRAIN_ARCH)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = opt.init(params)
    fn = ts.build_train_step(model, InputShape("train", cs.TRAIN_S,
                                               cs.TRAIN_B, "train"), None,
                             opt_cfg=opt.OptConfig(), microbatches=1)[0]
    dcfg = dpipe.DataConfig(cfg.vocab_size, cs.TRAIN_S, cs.TRAIN_B, seed=0)
    rows = []
    for step in range(cs.TRAIN_STEPS[0][1]):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = fn(params, state, dpipe.batch_at(dcfg, step, dev))
        loss = float(m["loss"])
        rows.append(dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                         loss=loss, grad_norm=float(m["grad_norm"]),
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        print(f"one-device step {step}: {rows[-1]}")
    after = {"steps": rows, "params": L.tree_map(lambda t: t.cpu(), params)}
    del params, state, model
    torch.cuda.empty_cache()
    return {"after": after}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.stdout.reconfigure(line_buffering=True)
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import _build
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    print(cs.nvidia_smi("name,power.limit"))
    t0 = time.perf_counter()
    for lib in ("flash_attention", "flash_attention_bwd", "decode_attention",
                "segment_sum"):
        _build.load(lib)
    print(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    trainer = one_device_steps(torch, cs, dev)
    out = cs.mesh_phase(torch, fa_mod, da_mod, dev,
                        {"decode_ms": float("nan")}, trainer)
    print(json.dumps({"mesh": out["launches"],
                      "mesh_tensor_parallel": out["tp_launches"],
                      "mesh_tensor_parallel_train": out["train_launches"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
