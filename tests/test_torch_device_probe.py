"""The device probes' plain versions on the CPU, against numpy.

One trip of each plain probe of ``utils/device_probe`` (the memory pass,
the bf16 ``bmm`` trip, a scatter shape of the menu) and the plain versions
of the three hand-written probe kernels of ``ops/probe_kernels``, at small
sizes: the multiply-then-add chains bit for bit (float32 rounds each
operation on both sides), the fused chain within one float32 ulp (numpy
has no fused multiply-add; float64 stands in), the products at rtol 1e-5
against float64 sums, bf16 at its own rounding (2^-8). The wrappers take
the plain versions for CPU tensors only and count no launch; a tensor on
another device is refused. The kernels themselves are held to these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
The library chains that ``utils/device_probe`` times beside the kernels
compute the plain versions' values, and a numpy emulation of each
kernel's order of summation (``csrc/device_probe.cu``) fits the
tolerances the card's kernels are held to.
"""

import numpy as np
import pytest
import torch

from rl_ode_physics_tpu_torch.ops import probe_kernels as pk
from rl_ode_physics_tpu_torch.utils import device_probe as dp

F32_ULP = 2.0 ** -23


def _numpy_chain(x, trips, fused=False):
    acc = x.astype(np.float32)
    scale, bias = np.float32(1.0000001), np.float32(1e-9)
    for _ in range(trips * pk.CHAIN):
        if fused:
            acc = (acc.astype(np.float64) * np.float64(scale)
                   + np.float64(bias)).astype(np.float32)
        else:
            acc = acc * scale + bias
    return acc


def test_hbm_trip_is_the_chain():
    x = np.random.default_rng(0).uniform(0.5, 2.0, 4096).astype(np.float32)
    t = torch.from_numpy(x.copy())
    out = dp.hbm_trip(t)
    assert out.data_ptr() == t.data_ptr()          # in place
    for _ in range(3):
        dp.hbm_trip(t)
    want = x.copy()
    for _ in range(4):
        want = want * np.float32(1.0000001) + np.float32(1e-9)
    assert np.array_equal(t.numpy(), want)


@pytest.mark.parametrize("shape,menu", [((4, 8, 64, 384), False),
                                        ((4, 8, 384, 64), True),
                                        ((2, 16, 128, 256), True)],
                         ids=["bmm", "menu-scatter", "menu-gather-paired"])
def test_bmm_trip_matches_numpy(shape, menu):
    b, m, kk, lanes = shape
    v, s = dp._bmm_inputs(b, m, kk, lanes, "cpu", menu)
    got = dp.bmm_trip(v, s)
    assert got.dtype == torch.bfloat16 and got.shape == (b, m, kk)
    vh = np.einsum("bmk,bkl->bml", v.float().numpy().astype(np.float64),
                   s.float().numpy().astype(np.float64))
    if lanes < kk:
        vh = np.pad(vh, ((0, 0), (0, 0), (0, kk - lanes)))
    want = v.float().numpy() + vh[..., :kk] * 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8)
    # the selector of probe_bmm sets every 7th entry
    if not menu:
        assert float(s.float().mean()) == pytest.approx(1 / 7, abs=1e-3)


def test_matmuls_plain_matches_numpy():
    rng = np.random.default_rng(1)
    vel = rng.normal(size=(3, pk.ROWS, pk.INNER)).astype(np.float32)
    s = rng.normal(size=(3, pk.INNER, pk.COLS)).astype(np.float32)
    acc, checksum = pk.probe_matmuls_plain(torch.from_numpy(vel),
                                           torch.from_numpy(s), 2)
    ref = vel.astype(np.float64)
    ref_sum = np.zeros(3)
    for _ in range(2 * pk.CHAIN):
        vh = ref @ s.astype(np.float64)
        ref_sum += vh.sum((1, 2))
        ref = ref + vh[..., :pk.INNER] * 1e-6
    np.testing.assert_allclose(acc.numpy(), ref, rtol=pk.MATMUL_RTOL,
                               atol=1e-6)
    assert checksum.dtype == torch.float64
    scale = np.abs(vh).sum((1, 2)) * 2 * pk.CHAIN
    assert (np.abs(checksum.numpy() - ref_sum) <= 1e-5 * scale).all()
    # the TPU probe's inputs: ones and 0.01, exact in any order of summation
    v1, s1 = dp.matmuls_inputs("cpu")
    a1, c1 = pk.probe_matmuls_plain(v1, s1, 1)
    assert bool(torch.isfinite(a1).all()) and bool((a1 > 1).all())
    assert bool((c1 > 0).all())


def _matmuls_float64_products(vel, s, trips):
    """The plain version with each product summed in float64 and rounded
    once: another order of summation, as the kernel's."""
    acc = vel.clone()
    checksum = torch.zeros(vel.shape[0], dtype=torch.float64)
    for _ in range(trips * pk.CHAIN):
        vh = torch.bmm(acc.double(), s.double()).float()
        checksum += vh.sum((1, 2), dtype=torch.float64)
        acc = acc + vh[..., :pk.INNER] * 1e-6
    return acc, checksum


@pytest.mark.parametrize("inputs", ["random", "tpu-probe"])
def test_matmuls_check_refuses_a_wrong_product(inputs):
    """``matmuls_agree`` passes a product summed in another order and
    refuses one 1% off in the columns that feed acc or in the others."""
    if inputs == "random":
        g = torch.Generator().manual_seed(5)
        vel = torch.randn((4, pk.ROWS, pk.INNER), generator=g)
        s = torch.randn((4, pk.INNER, pk.COLS), generator=g)
    else:
        vel, s = dp.matmuls_inputs("cpu")
    want = pk.probe_matmuls_plain(vel, s, 2)
    errors = pk.matmuls_errors(vel, _matmuls_float64_products(vel, s, 2),
                               want)
    assert pk.matmuls_agree(errors), errors
    assert pk.matmuls_agree(pk.matmuls_errors(vel, want, want))
    for cols in (slice(0, pk.INNER), slice(pk.INNER, None)):
        off = s.clone()
        off[..., cols] *= 1.01
        got = pk.probe_matmuls_plain(vel, off, 2)
        assert not pk.matmuls_agree(pk.matmuls_errors(vel, got, want)), cols


@pytest.mark.parametrize("fused", [False, True], ids=["mul-add", "fma"])
@pytest.mark.parametrize("n", [3 * pk.VPU_THREADS, 12 * pk.VPU_THREADS])
def test_vpu_plain_matches_numpy(n, fused):
    x = np.random.default_rng(n).uniform(0.5, 2.0, n).astype(np.float32)
    got = pk.probe_vpu_plain(torch.from_numpy(x), 3, fused).numpy()
    want = _numpy_chain(x, 3, fused)
    if fused:
        np.testing.assert_allclose(got, want, rtol=F32_ULP, atol=0)
    else:
        assert np.array_equal(got, want)
    assert not np.array_equal(got, x)


def test_mxu_plain_matches_numpy():
    a, b = dp.mxu_inputs("cpu")
    assert torch.equal(pk.probe_mxu_plain(a, b, 5), a)   # exactly A again
    rng = np.random.default_rng(2)
    a = rng.normal(size=(pk.MXU_N, pk.MXU_N)).astype(np.float32)
    b = (rng.normal(size=(pk.MXU_N, pk.MXU_N)) / 16).astype(np.float32)
    got = pk.probe_mxu_plain(torch.from_numpy(a), torch.from_numpy(b), 3)
    want = a.astype(np.float64)
    for _ in range(3):
        want = (want @ b.astype(np.float64)) * 0.0625
    np.testing.assert_allclose(got.numpy(), want, rtol=pk.MATMUL_RTOL,
                               atol=1e-5 * np.abs(want).max())


def test_wrappers_take_the_plain_versions_on_the_cpu_only():
    for fn in (pk.probe_matmuls, pk.probe_vpu, pk.probe_mxu):
        fn.launches = 0
    vel, s = dp.matmuls_inputs("cpu")
    got = pk.probe_matmuls(vel, s, 1)
    want = pk.probe_matmuls_plain(vel, s, 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x = torch.ones(3 * pk.VPU_THREADS)
    assert torch.equal(pk.probe_vpu(x, 2), pk.probe_vpu_plain(x, 2))
    a, b = dp.mxu_inputs("cpu")
    assert torch.equal(pk.probe_mxu(a, b, 2), pk.probe_mxu_plain(a, b, 2))
    assert (pk.probe_matmuls.launches, pk.probe_vpu.launches,
            pk.probe_mxu.launches) == (0, 0, 0)
    # a tensor on another device goes to the kernel's checks, not the CPU
    with pytest.raises(ValueError):
        pk.probe_vpu(torch.ones(3 * pk.VPU_THREADS, device="meta"), 1)
    with pytest.raises(ValueError):
        pk.probe_mxu(a.to("meta"), b.to("meta"), 1)


def test_bounds_and_counts():
    """What the probes divide by: the data sheet's figures, and the share
    of the 132 SMs a kernel runs on."""
    assert dp._fp32_bound_ms(67e12 / 132 * 1e-3, 1) == pytest.approx(1.0)
    assert dp._fp32_bound_ms(67e12 * 1e-3, 132) == pytest.approx(1.0)
    assert [s[:4] for s in dp.SHAPE_MENU][:2] == [(2048, 8, 64, 384),
                                                 (2048, 8, 384, 64)]
    assert dp.MATMULS_TRIPS == (256, 4096) and dp.MXU_STEPS == (4096, 65536)


def test_measured_fields():
    """``measured`` reads the (256, 256) chain's rate per SM on the SMs of
    its cluster and the fused chain's of one SM."""
    out = dict(hbm=[dict(gb_per_s=2900.0), dict(gb_per_s=3000.0)],
               kernel_vpu=[dict(fused=False, tflop_per_s_per_sm=0.25),
                           dict(fused=True, tflop_per_s_per_sm=0.5)],
               mxu_peak=[dict(tflop_per_s_per_sm=0.3, sms=pk.MXU_CLUSTER,
                              tflop_per_s_x132=0.3 * 132)])
    m = dp.measured(out)
    assert m["fp32_tflop_per_s_per_sm"] == 0.3 and m["sms"] == 16
    assert m["fp32_tflop_per_s_x132"] == pytest.approx(39.6)
    assert m["fp32_fma_chain_tflop_per_s_x132"] == pytest.approx(66.0)
    assert m["memory_gb_per_s"] == 3000.0
    assert "fp32_tflop_per_s_one_sm" not in m
    # the chain's bound on its 16 SMs at the first product count: 16.9 ms
    ops = 2 * pk.MXU_N ** 3 * dp.MXU_STEPS[0]
    assert dp._fp32_bound_ms(ops, pk.MXU_CLUSTER) == pytest.approx(
        16.92, abs=0.01)


# ---------------------------------------------------------------------------
# the library chains
# ---------------------------------------------------------------------------

def test_mxu_library_chain_is_the_plain_chain_bitwise():
    rng = np.random.default_rng(41)
    a = torch.from_numpy(rng.normal(size=(pk.MXU_N, pk.MXU_N))
                         .astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(pk.MXU_N, pk.MXU_N)) / 16)
                         .astype(np.float32))
    assert torch.equal(dp.mxu_library_chain(a, b, 3),
                       pk.probe_mxu_plain(a, b, 3))


def test_vpu_library_chain_is_one_addcmul_a_step(monkeypatch):
    """The fused plain chain, which ``probe_kernel_vpu`` times as its
    library chain, is one ``torch.addcmul`` a step and nothing else."""
    x = torch.from_numpy(np.random.default_rng(43).uniform(
        0.5, 2.0, 3 * pk.VPU_THREADS).astype(np.float32))
    calls = []

    def addcmul(*args, **kwargs):
        calls.append(1)
        return torch_addcmul(*args, **kwargs)

    torch_addcmul = torch.addcmul
    monkeypatch.setattr(torch, "addcmul", addcmul)
    got = pk.probe_vpu_plain(x, 3, fused=True)
    assert len(calls) == 3 * pk.CHAIN
    np.testing.assert_allclose(got.numpy(), _numpy_chain(x.numpy(), 3, True),
                               rtol=F32_ULP, atol=0)


def test_bmm_product_is_the_plain_step_product():
    """The library chain's one call a step is the plain version's product:
    its first step's update and checksum come out of it exactly."""
    rng = np.random.default_rng(47)
    vel = torch.from_numpy(rng.normal(size=(3, pk.ROWS, pk.INNER))
                           .astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(3, pk.INNER, pk.COLS))
                         .astype(np.float32))
    vh = dp.matmuls_library_products(vel, s, 1)
    assert vh.shape == (3, pk.ROWS, pk.COLS)
    acc, checksum = pk.probe_matmuls_plain(vel, s, 1)
    # the plain chain's 16 steps, the first one taken from the library call
    want, want_sum = vel + vh[..., :pk.INNER] * 1e-6, vh.sum(
        (1, 2), dtype=torch.float64)
    for _ in range(pk.CHAIN - 1):
        step = torch.bmm(want, s)
        want_sum += step.sum((1, 2), dtype=torch.float64)
        want = want + step[..., :pk.INNER] * 1e-6
    assert torch.equal(acc, want) and torch.equal(checksum, want_sum)


# ---------------------------------------------------------------------------
# the kernels' orders of summation, emulated
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """fmaf in numpy: the product exact in float64, the sum rounded to
    float64 and then to float32 (at most one float32 rounding away from a
    fused multiply-add)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _matmuls_kernel_order(vel, s, trips):
    """``probe_matmuls_kernel``'s arithmetic. The 64 columns of acc: one
    sequential FMA chain over k a value (the plain product's order), acc +
    vh · 1e-6 rounded as multiply, then add; the lane of column c adds its
    8 rows in float32 for the checksum. The other 320 columns: lane g of a
    quad sums k = 16m + 4g + e (m, e < 4) in that order by FMAs, the
    quad's partials meet as (p0 + p1) + (p2 + p3), and each lane adds its
    2 rows × 4 columns in float32, row by row. The checksum adds the
    lanes' float32 sums in float64."""
    acc = vel.astype(np.float32)
    w = vel.shape[0]
    checksum = np.zeros(w)
    for _ in range(trips * pk.CHAIN):
        vh = np.zeros((w, pk.ROWS, pk.INNER), np.float32)
        for k in range(pk.INNER):
            vh = _fma32(acc[:, :, k:k + 1], s[:, k:k + 1, :pk.INNER], vh)
        column_sums = vh[:, 0]
        for r in range(1, pk.ROWS):
            column_sums = column_sums + vh[:, r]
        parts = []
        for g in range(4):
            part = np.zeros((w, pk.ROWS, pk.COLS - pk.INNER), np.float32)
            for m in range(4):
                for e in range(4):
                    k = 16 * m + 4 * g + e
                    part = _fma32(acc[:, :, k:k + 1], s[:, k:k + 1, pk.INNER:],
                                  part)
            parts.append(part)
        rest = (parts[0] + parts[1]) + (parts[2] + parts[3])
        # (W, row pair, 2 rows, column group, 4 columns) → a lane's 8
        lanes = rest.reshape(w, 4, 2, -1, 4).transpose(0, 1, 3, 2, 4) \
            .reshape(w, 4, -1, 8)
        eight = lanes[..., 0]
        for i in range(1, 8):
            eight = eight + lanes[..., i]
        checksum += (column_sums.astype(np.float64).sum(1)
                     + eight.astype(np.float64).sum((1, 2)))
        acc = acc + vh * np.float32(1e-6)
    return acc, checksum


def _mxu_kernel_order(a, b, steps):
    """``probe_mxu_kernel``'s arithmetic: every output four sequential FMA
    chains, over each quarter of k = 0 .. 255, summed as (p0 + p1) +
    (p2 + p3), then scaled by 0.0625."""
    acc = a.astype(np.float32)
    quarter = pk.MXU_N // 4
    for _ in range(steps):
        parts = []
        for q in range(4):
            t = np.zeros_like(acc)
            for k in range(q * quarter, (q + 1) * quarter):
                t = _fma32(acc[:, k:k + 1], b[k:k + 1, :], t)
            parts.append(t)
        acc = ((parts[0] + parts[1]) + (parts[2] + parts[3])) \
            * np.float32(0.0625)
    return acc


@pytest.mark.parametrize("trips", [1, 2, 3])
@pytest.mark.parametrize("inputs", ["random", "tpu-probe"])
def test_matmuls_kernel_order_fits_the_tolerance(inputs, trips):
    """The kernel's order of summation passes ``matmuls_agree`` against
    the plain version on its own, so the card check does not pass by its
    tolerance alone: acc is the plain version's bit for bit where the
    plain product sums k in order by FMAs, as numpy's float64 emulation
    of it does within a rounding; a product 1% off in the columns of acc
    still fails."""
    if inputs == "random":
        rng = np.random.default_rng(53 + trips)
        vel = rng.normal(size=(8, pk.ROWS, pk.INNER)).astype(np.float32)
        s = rng.normal(size=(8, pk.INNER, pk.COLS)).astype(np.float32)
    else:
        vel, s = (x.numpy() for x in dp.matmuls_inputs("cpu"))
    tv, ts = torch.from_numpy(vel), torch.from_numpy(s)
    want = pk.probe_matmuls_plain(tv, ts, trips)
    acc, checksum = _matmuls_kernel_order(vel, s, trips)
    got = (torch.from_numpy(acc), torch.from_numpy(checksum))
    errors = pk.matmuls_errors(tv, got, want)
    assert pk.matmuls_agree(errors), errors
    off = s.copy()
    off[..., :pk.INNER] *= np.float32(1.01)
    wrong = _matmuls_kernel_order(vel, off, trips)
    assert not pk.matmuls_agree(pk.matmuls_errors(
        tv, tuple(torch.from_numpy(x) for x in wrong), want))


@pytest.mark.parametrize("inputs", ["random", "ones"])
def test_mxu_kernel_order_fits_the_tolerance(inputs):
    """Four FMA chains an output, one a quarter of k: within
    ``MATMUL_RTOL`` of the plain version on random inputs (the card's
    check), exactly it at A = 1, B = 1/16."""
    if inputs == "random":
        rng = np.random.default_rng(59)
        a = rng.normal(size=(pk.MXU_N, pk.MXU_N)).astype(np.float32)
        b = (rng.normal(size=(pk.MXU_N, pk.MXU_N)) / 16).astype(np.float32)
    else:
        a, b = (x.numpy() for x in dp.mxu_inputs("cpu"))
    ref = pk.probe_mxu_plain(torch.from_numpy(a), torch.from_numpy(b), 3)
    got = torch.from_numpy(_mxu_kernel_order(a, b, 3))
    if inputs == "ones":
        assert torch.equal(got, ref)
    else:
        assert torch.allclose(got, ref, rtol=pk.MATMUL_RTOL,
                              atol=pk.MATMUL_RTOL * float(ref.abs().max()))
