"""PyTorch port, core: packing, quantization, BitLinear, configs, params,
interop, and the port's import and device policy.

Inputs are made with numpy from fixed seeds and fed to both packages.
Bars: exact wherever integer arithmetic decides (pack2 bytes, int8 codes
and scales on identical input, the unpack->matmul path of BitLinear).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import bitlinear as jBL
from repro.core import packing as jPK
from repro.core import ternary as jT
from repro_torch import _common as C
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import bitlinear as BL
from repro_torch.core import packing as PK
from repro_torch.core import params as PR
from repro_torch.core import ternary as TQ
from repro_torch.kernels import KERNELS
from repro_torch.models import transformer as TT

REPO = Path(__file__).resolve().parents[1]


def _trits(rng, shape):
    return rng.integers(-1, 2, shape).astype(np.int8)


@pytest.mark.parametrize("shape", [(8, 5), (36, 7), (4, 3, 2)])
def test_pack2_bytes_match_jax(shape):
    w = _trits(np.random.default_rng(1), shape)
    got = PK.pack2(torch.from_numpy(w)).numpy()
    want = np.asarray(jPK.pack2(jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PK.unpack2(torch.from_numpy(got)).numpy(), w)


def test_pack2_rejects_ragged_first_axis():
    with pytest.raises(ValueError):
        PK.pack2(torch.zeros((6, 3), dtype=torch.int8))


def test_zero_trit_pad_byte():
    """The pad byte 0x55 decodes to four zero trits."""
    byte = torch.tensor([[PK.ZERO_TRITS_BYTE]], dtype=torch.uint8)
    assert PK.unpack2(byte).abs().sum().item() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_exact(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((6, 50)) * 3).astype(np.float32)
    x[2] = 0.0  # all-zero row: the 1e-8 floor
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(C.DTYPES[dtype])
    qj, sj = jT.quantize_act(xj)
    qt, st = TQ.quantize_act(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_ternarize_matches_jax():
    """Codes equal; the absmean scale is an f32 mean summed in another order,
    so it agrees to a few ulp (rtol 1e-6)."""
    w = np.random.default_rng(3).standard_normal((32, 24)).astype(np.float32)
    wt, st = TQ.ternarize(torch.from_numpy(w))
    wj, sj = jT.ternarize(jnp.asarray(w))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(st.item(), float(sj), rtol=1e-6)


def _packed_node(rng, n, k):
    w = _trits(rng, (n, k))
    return ({"wp": jPK.pack2(jnp.asarray(w)), "scale": jnp.float32(0.37)},
            {"wp": PK.pack2(torch.from_numpy(w)), "scale": torch.tensor(0.37)})


@pytest.mark.parametrize("m", [1, 5, 40])
@pytest.mark.parametrize("with_residual", [False, True])
def test_bitlinear_packed_apply_exact(m, with_residual):
    """The unpack->matmul path of ``bitlinear.apply`` on a pre-quantized
    pair, with and without the residual epilogue: bit-identical."""
    rng = np.random.default_rng(4)
    jp, tp = _packed_node(rng, 68, 20)
    x = rng.integers(-127, 128, (m, 68)).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    r = rng.standard_normal((m, 20)).astype(np.float32) if with_residual else None
    want = jBL.apply(jp, (jnp.asarray(x), jnp.asarray(xs)), mode="packed",
                     out_dtype=jnp.float32,
                     residual=None if r is None else jnp.asarray(r))
    got = BL.apply(tp, (torch.from_numpy(x), torch.from_numpy(xs)), kernels=KERNELS,
                   out_dtype=torch.float32,
                   residual=None if r is None else torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bitlinear_float_input_exact():
    rng = np.random.default_rng(5)
    jp, tp = _packed_node(rng, 32, 12)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    want = jBL.apply(jp, jnp.asarray(x), mode="packed")
    got = BL.apply(tp, torch.from_numpy(x), kernels=KERNELS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_params_matches_jax_for_equal_scale():
    """Stacked packing: one scale per matrix; bytes equal to JAX's."""
    w = np.random.default_rng(6).standard_normal((2, 16, 8)).astype(np.float32)
    got = BL.pack_params(torch.from_numpy(w))
    want = jBL.pack_params(jnp.asarray(w))
    assert tuple(got["wp"].shape) == want["wp"].shape == (2, 4, 8)
    np.testing.assert_array_equal(got["wp"].numpy(), np.asarray(want["wp"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]), rtol=1e-6)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_jax(smoke):
    tc = t_get_config("tellme-0.7b", smoke=smoke)
    jc = get_config("tellme-0.7b", smoke=smoke)
    for f in dataclasses.fields(tc):
        if f.name == "dtype":
            continue
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.padded_vocab == jc.padded_vocab
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name


def test_param_specs_match_jax_tree():
    """Same keys and shapes as the JAX spec tree, leaf by leaf."""
    from repro.core.params import _iter_specs
    from repro.models import transformer as jTr

    cfg = get_config("tellme-0.7b", smoke=True)
    want = {p: s.shape for p, s in _iter_specs(jTr.param_specs(cfg))}
    got = {}
    PR.map_specs(lambda p, s: got.__setitem__(p, s.shape),
                 TT.param_specs(t_get_config("tellme-0.7b", smoke=True)))
    assert got == want


def test_init_params_distributions_and_determinism():
    specs = {"w": PR.ParamSpec((256, 64)), "e": PR.ParamSpec((64, 32), init="embed", scale=0.02),
             "g": PR.ParamSpec((32,), init="ones")}
    a = PR.init_params(specs, seed=0, device="cpu")
    b = PR.init_params(specs, seed=0, device="cpu")
    c = PR.init_params(specs, seed=1, device="cpu")
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
    assert abs(a["w"].std().item() - 1 / 16) < 0.005  # N(0, 1/fan_in)
    assert abs(a["e"].std().item() - 0.02) < 0.003
    assert torch.equal(a["g"], torch.ones(32))


def test_pack_tree_casts_dense_leaves_once():
    cfg = t_get_config("tellme-0.7b", smoke=True)
    specs = TT.param_specs(cfg)
    packed = TT.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                          dtype=torch.bfloat16)
    blk = packed["blocks"]["b0"]
    assert blk["attn"]["q"]["wp"].dtype == torch.uint8
    assert tuple(blk["attn"]["q"]["wp"].shape) == (2, 16, 64)
    assert tuple(blk["attn"]["q"]["scale"].shape) == (2,)
    assert blk["ln1"]["gamma"].dtype == torch.float32
    assert packed["lm_head"]["w"].dtype == torch.bfloat16
    assert packed["embed"]["table"].dtype == torch.bfloat16


def test_interop_carries_bytes_and_bf16_bits():
    from repro_torch import interop

    cfg = t_get_config("tellme-0.7b", smoke=True)
    wp = np.arange(12, dtype=np.uint8).reshape(3, 4)
    table = np.asarray(jnp.asarray(np.linspace(-1, 1, 8).reshape(2, 4)).astype(jnp.bfloat16))
    tree = {"embed": {"table": table}, "blocks": {"b0": {"q": {"wp": wp, "scale": np.float32(2.0)}}}}
    got = interop.from_jax_params(tree, cfg, device="cpu")
    assert torch.equal(got["blocks"]["b0"]["q"]["wp"], torch.from_numpy(wp))
    assert got["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"]["table"].float().numpy(),
                                  table.astype(np.float32))


def test_common_helpers():
    assert C.round_up(5, 4) == 8 and C.round_up(8, 4) == 8
    x = torch.arange(6).reshape(1, 2, 3)
    x2, lead, m = C.flatten_lead(x)
    assert tuple(x2.shape) == (2, 3) and lead == (1, 2) and m == 2
    p = C.pad_to(torch.ones(2, 3, dtype=torch.uint8), 1, 5, value=0x55)
    assert p.shape == (2, 5) and p[0, 4].item() == 0x55


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, import without JAX or the
    JAX package (checked in a fresh interpreter)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.path[:0] = ['src', '.']\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")


def test_entry_points_raise_without_cuda(no_card):
    """No card and no explicit CPU: the entry points raise instead of
    running on the host."""
    from repro_torch import interop
    from repro_torch.serving import engine as TE

    cfg = t_get_config("tellme-0.7b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        C.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.generate({}, cfg, np.zeros((1, 3), np.int64), steps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.from_jax_params({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.init_caches(cfg, 1, 8)


def test_chip_smoke_fails_without_cuda(no_card, capsys):
    import chip_smoke

    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_kernel_wrappers_refuse_non_cuda_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, never run
    through the plain version."""
    from repro_torch.kernels.fused_norm_quant import ops as nq_ops

    x = torch.ones((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        nq_ops.norm_quant(x, torch.ones(8, device="meta"))
