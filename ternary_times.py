"""Device times of the packed GEMV and SwiGLU wrappers (``ternary_gemv``,
``ternary_swiglu``) at the shapes the models give them, on one CUDA card.

    python3 ternary_times.py --out times.json
    python3 ternary_times.py --src /path/to/other/checkout/src --out old.json

``--src`` points at the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so two versions of the kernels can be timed in
one process run after another on the same card. Each time is the replay of
a CUDA graph of many calls over copies of the weights that exceed the L2
(``chip_smoke.time_ms``), beside the launch-by-launch time
(``chip_smoke.eager_ms``) and the bound (``chip_smoke.bound_ms``). The
SwiGLU rows also time ``twin_ms``: two ``ternary_matmul`` calls of the
same shapes into the act dtype, a yardstick for pass 1 and no library call.
Inputs are random from a fixed seed; the outputs are not checked here
(``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# (name, M, N, K, residual): tellme-0.7b's decode projections (q/k/v, down +
# residual) at generate's 4 rows and the engine's 8 slots, then rwkv6-3b's
# at M = 4 (d -> d, d -> d_ff, d_ff -> d)
GEMV_SHAPES = (("tellme q/k/v", 4, 1536, 1536, False), ("tellme down+res", 4, 4096, 1536, True),
               ("tellme q/k/v, 8 slots", 8, 1536, 1536, False),
               ("tellme down+res, 8 slots", 8, 4096, 1536, True),
               ("rwkv d->d", 4, 2560, 2560, False), ("rwkv d->d_ff", 4, 2560, 8960, False),
               ("rwkv d_ff->d", 4, 8960, 2560, False))
# tellme-0.7b's SwiGLU: generate's decode, the engine's 8 slots, a 4 x 128
# prefill, the chunk step's 8 x 256 rows and the 4096-token prefill's bucket
SWIGLU_ROWS = (4, 8, 512, 2048, 4096)
D_MODEL, D_FF = 1536, 4096


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ternary_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as CS
    from repro_torch.core import packing as PK
    from repro_torch.kernels.ternary_matmul import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    bf16 = torch.bfloat16

    def packed(n, k):
        return PK.pack2(torch.randint(-1, 2, (n, k), generator=gen, device=dev,
                                      dtype=torch.int8))

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def scales(m):
        return torch.rand((m, 1), generator=gen, device=dev) * 1e-3 + 1e-4

    rows = []
    for tag, m, n, k, residual in GEMV_SHAPES:
        wp = packed(n, k)
        ws = torch.tensor(0.02, device=dev)
        x, xs = int8(m, n), scales(m)
        res = torch.randn((m, k), generator=gen, device=dev).to(bf16) if residual else None
        sets = [(x, xs, wp.clone(), ws) for _ in range(CS.copies_for(wp.numel()))]

        def gemv(*a, res=res):
            return ops.ternary_gemv(*a, out_dtype=bf16, residual=res)

        bms, bby = CS.bound_ms(CS._nbytes(x, xs, wp, ws, res) + m * k * 2, 2 * m * n * k, "int8")
        rows.append({"kernel": "ternary_gemv", "shape": tag, "m": m, "n": n, "k": k,
                     "ms": CS.time_ms(torch, gemv, sets), "eager_ms": CS.eager_ms(torch, gemv, sets),
                     "bound_ms": bms, "bound_by": bby})
    wg, wu = packed(D_MODEL, D_FF), packed(D_MODEL, D_FF)
    sg, su = torch.tensor(0.03, device=dev), torch.tensor(0.025, device=dev)
    for m in SWIGLU_ROWS:
        x, xs = int8(m, D_MODEL), scales(m)
        n_copies = CS.copies_for(2 * wg.numel())
        sets = [(x, xs, wg.clone(), sg, wu.clone(), su) for _ in range(n_copies)]

        def swiglu(*a):
            return ops.ternary_swiglu(*a, act_dtype=bf16)

        def twin(x, xs, wg, sg, wu, su):
            mm = ops.ternary_matmul
            return (mm(x, xs, wg, sg, out_dtype=bf16), mm(x, xs, wu, su, out_dtype=bf16))

        nb = CS._nbytes(x, xs, wg, wu, sg, su) + m * D_FF + m * 4
        bms, bby = CS.bound_ms(nb, 4 * m * D_MODEL * D_FF, "int8")
        rows.append({"kernel": "ternary_swiglu", "shape": f"[{m},{D_MODEL}] x 2 [{D_MODEL // 4},"
                     f"{D_FF}]", "m": m, "n": D_MODEL, "k": D_FF,
                     "ms": CS.time_ms(torch, swiglu, sets, iters=100 if m <= 512 else 20),
                     "eager_ms": CS.eager_ms(torch, swiglu, sets, iters=200 if m <= 512 else 40),
                     "twin_ms": CS.time_ms(torch, twin, sets, iters=100 if m <= 512 else 20),
                     "bound_ms": bms, "bound_by": bby})
    out = {"tag": args.tag, "src": os.path.abspath(args.src), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": CS.nvidia_smi_line(), "rows": rows}
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
