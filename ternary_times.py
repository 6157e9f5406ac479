"""Device times of the packed GEMV and SwiGLU wrappers (``ternary_gemv``,
``ternary_swiglu``), the block prologue (``norm_quant``) and the
table-lookup kernels (``tl_gemv``, ``tl_matmul``, ``tl_swiglu``) at the
shapes the models give them, on one CUDA card.

    python3 ternary_times.py --out times.json
    python3 ternary_times.py --src /path/to/other/checkout/src --out old.json
    python3 ternary_times.py --against old.json --out new.json

``--src`` points at the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so two versions of the kernels can be timed in
one process run after another on the same card. Each time is the replay of
a CUDA graph of many calls over copies of the weights that exceed the L2
(``chip_smoke.time_ms``), beside the launch-by-launch time
(``chip_smoke.eager_ms``) and the bound (``chip_smoke.bound_ms``). The
SwiGLU rows also time ``twin_ms``: two ``ternary_matmul`` calls of the
same shapes into the act dtype, a yardstick for pass 1 and no library call;
the TL rows time their packed twin (``ternary_gemv``, ``ternary_matmul``,
``ternary_swiglu`` on the same weights). ``norm_quant`` runs at generate's
4 decode rows, the engine's 8, a 4 x 128 prefill, the 4096-token prefill
and rwkv6-3b's d_model, in bf16; each row carries the SHA-256 of its codes
and of its scales, and ``--against`` (another run's ``--out``) prints
whether they are bit-equal to that run's, shape by shape. Inputs are
random from a fixed seed (the prologue's from a generator of its own per
shape, so that two versions see the same rows); the other outputs are not
checked here (``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
them).
"""

from __future__ import annotations

import argparse
import hashlib
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
# norm_quant (M, N) in bf16: generate's decode, the engine's 8 slots, a 4 x
# 128 prefill, the 4096-token prefill, rwkv6-3b's d_model at M = 4
NORM_QUANT_SHAPES = ((4, 1536), (8, 1536), (512, 1536), (4096, 1536), (4, 2560))
# chip_smoke's seven TL projections (kernel, M, N, K, residual, from
# tables): tl_gemv at decode, tl_matmul at decode and at 512 rows
TL_SHAPES = (("tl_gemv", 4, 1536, 1536, False, False), ("tl_gemv", 4, 4096, 1536, False, False),
             ("tl_matmul", 4, 1536, 1536, False, True), ("tl_matmul", 4, 4096, 1536, True, False),
             ("tl_matmul", 512, 1536, 1536, False, True),
             ("tl_matmul", 512, 1536, 1536, False, False),
             ("tl_matmul", 512, 4096, 1536, True, False))
TL_SWIGLU_ROWS = (4, 512)


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def norm_quant_rows(torch, CS, dev) -> list[dict]:
    from repro_torch.kernels.fused_norm_quant import ops as nq_ops

    rows = []
    for m, n in NORM_QUANT_SHAPES:
        g = torch.Generator(device=dev)
        g.manual_seed(4321 + 7 * m + n)
        x = (torch.randn((m, n), generator=g, device=dev) * 3).to(torch.bfloat16)
        gamma = torch.randn((n,), generator=g, device=dev)
        q, qs = nq_ops.norm_quant(x, gamma)
        bms, bby = CS.bound_ms(CS._nbytes(x, gamma, q, qs), 5 * x.numel(), "f32")
        sets = [(x, gamma)]
        rows.append({"kernel": "norm_quant", "shape": f"x[{m},{n}] bf16", "m": m, "n": n,
                     "ms": CS.time_ms(torch, nq_ops.norm_quant, sets),
                     "eager_ms": CS.eager_ms(torch, nq_ops.norm_quant, sets),
                     "bound_ms": bms, "bound_by": bby,
                     "codes_sha256": _digest(q), "scales_sha256": _digest(qs)})
    return rows


def tl_rows(torch, CS, PK, gen, dev) -> list[dict]:
    from repro_torch.core import tl_matmul as TL
    from repro_torch.kernels.ternary_matmul import ops as tm_ops
    from repro_torch.kernels.tl_gemv import ops as tl_ops

    bf16 = torch.bfloat16

    def packed(n, k):
        return PK.pack2(torch.randint(-1, 2, (n, k), generator=gen, device=dev,
                                      dtype=torch.int8))

    def operands(m, n):
        x = torch.randint(-127, 128, (m, n), generator=gen, device=dev, dtype=torch.int8)
        return x, torch.rand((m, 1), generator=gen, device=dev) * 1e-3 + 1e-4

    rows = []
    for name, m, n, k, residual, from_tables in TL_SHAPES:
        wp = packed(n, k)
        w_idx = TL.tl_indices(wp)
        t = w_idx.shape[0]
        ws = torch.tensor(0.02, device=dev)
        x, xs = operands(m, n)
        tab = TL.build_tables(x, t=t) if from_tables else None
        res = torch.randn((m, k), generator=gen, device=dev).to(bf16) if residual else None
        if name == "tl_gemv":
            fn, twin_fn, kw, twin_kw = tl_ops.tl_gemv, tm_ops.ternary_gemv, {}, {}
        else:
            fn = tl_ops.tl_matmul
            twin_fn = tm_ops.ternary_gemv if m <= 16 else tm_ops.ternary_matmul
            kw = {"tables": tab, "residual": res, "out_dtype": bf16}
            twin_kw = {"residual": res, "out_dtype": bf16}
        out_bytes = m * k * (4 if name == "tl_gemv" else 2)
        nb = (CS._nbytes(xs, w_idx, ws, res) + (CS._nbytes(tab) if from_tables else CS._nbytes(x))
              + out_bytes)
        bms, bby = CS.bound_ms(nb, m * t * k + (0 if from_tables else 2 * 27 * m * t), "f32")
        sets = [(x, xs, w_idx.clone(), ws) for _ in range(CS.copies_for(w_idx.numel()))]
        twin_sets = [(x, xs, wp.clone(), ws) for _ in range(CS.copies_for(wp.numel()))]
        tag = ("tables" if from_tables else "int8") + (" +res" if residual else "")
        rows.append({"kernel": name, "shape": f"x[{m},{n}] x w_idx[{t},{k}], {tag}",
                     "m": m, "n": n, "k": k,
                     "ms": CS.time_ms(torch, lambda *a: fn(*a, **kw), sets),
                     "eager_ms": CS.eager_ms(torch, lambda *a: fn(*a, **kw), sets),
                     "twin_ms": CS.time_ms(torch, lambda *a: twin_fn(*a, **twin_kw), twin_sets),
                     "twin": twin_fn.__name__, "bound_ms": bms, "bound_by": bby})
    wg, wu = packed(D_MODEL, D_FF), packed(D_MODEL, D_FF)
    ig, iu = TL.tl_indices(wg), TL.tl_indices(wu)
    sg, su = torch.tensor(0.03, device=dev), torch.tensor(0.025, device=dev)
    t = ig.shape[0]
    for m in TL_SWIGLU_ROWS:
        x, xs = operands(m, D_MODEL)
        tab = TL.build_tables(x, t=t)
        kw = {"tables": tab, "act_dtype": bf16}
        sets = [(x, xs, ig.clone(), sg, iu.clone(), su) for _ in range(CS.copies_for(2 * ig.numel()))]
        twin_sets = [(x, xs, wg.clone(), sg, wu.clone(), su)
                     for _ in range(CS.copies_for(2 * wg.numel()))]
        nb = CS._nbytes(tab, xs, ig, iu, sg, su) + m * D_FF + m * 4
        bms, bby = CS.bound_ms(nb, 2 * m * t * D_FF, "f32")
        rows.append({"kernel": "tl_swiglu", "shape": f"tables[{m},{tab.shape[1]}] x 2 w_idx[{t},"
                     f"{D_FF}]", "m": m, "n": D_MODEL, "k": D_FF,
                     "ms": CS.time_ms(torch, lambda *a: tl_ops.tl_swiglu(*a, **kw), sets),
                     "eager_ms": CS.eager_ms(torch, lambda *a: tl_ops.tl_swiglu(*a, **kw), sets),
                     "twin_ms": CS.time_ms(torch, lambda *a: tm_ops.ternary_swiglu(
                         *a, act_dtype=bf16), twin_sets),
                     "twin": "ternary_swiglu", "bound_ms": bms, "bound_by": bby})
    return rows


def compare_norm_quant(rows, against: str) -> list[dict]:
    """Each norm_quant row's codes and scales against the same shape's in
    another run's output, by digest."""
    with open(against) as f:
        theirs = {r["shape"]: r for r in json.load(f)["rows"] if r["kernel"] == "norm_quant"}
    out = []
    for r in rows:
        if r["kernel"] != "norm_quant":
            continue
        o = theirs.get(r["shape"])
        out.append({"shape": r["shape"], "codes_equal": bool(o) and
                    o["codes_sha256"] == r["codes_sha256"],
                    "scales_equal": bool(o) and o["scales_sha256"] == r["scales_sha256"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--against", default=None,
                    help="another run's --out: compare norm_quant's codes and scales")
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
    rows += norm_quant_rows(torch, CS, dev)
    rows += tl_rows(torch, CS, PK, gen, dev)
    out = {"tag": args.tag, "src": os.path.abspath(args.src), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": CS.nvidia_smi_line(), "rows": rows}
    if args.against:
        out["norm_quant_bit_equal"] = compare_norm_quant(rows, args.against)
        print(json.dumps({"norm_quant_bit_equal": out["norm_quant_bit_equal"]}), flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
