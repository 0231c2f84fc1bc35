"""The port's live-entry compaction (its plain versions, on the CPU)
against the JAX package's partition kernel in interpret mode, and its
ray form against its payload form.

The port's payload is entry-major [N, R]; the JAX package's is [R, N],
so the tests transpose.  Held: ``n_live`` equal and the live prefix
equal to the bit.  Past the prefix both leave entries undefined, so
nothing there is compared.  The CUDA kernel is held against the plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_raytracer_tpu.ops.pallas import partition as jax_partition

import torch

from cuda_raytracer_tpu_torch.ops import partition as pt
from cuda_raytracer_tpu_torch.ops import wavefront2 as wf
from torch_threads import _one_torch_thread  # noqa: F401


def _liveness(name, n):
    if name == "all_live":
        return np.ones(n, bool)
    if name == "all_dead":
        return np.zeros(n, bool)
    if name == "one_live":
        m = np.zeros(n, bool)
        m[n - 1025] = True
        return m
    # an irregular 30%, so live lanes straddle block boundaries
    return (np.arange(n) * 2654435761 % 97) < 30


def _payload(n, rows, live, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((rows, n)).astype(np.float32)
    p[7] = np.where(live, rng.random(n).astype(np.float32), -1.0)
    return p


@pytest.mark.parametrize("pattern",
                         ["all_live", "all_dead", "irregular", "one_live"])
@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("n", [2048, 4096])
def test_matches_pallas_partition(monkeypatch, n, rows, pattern):
    monkeypatch.setattr(jax_partition, "_INTERPRET", True)
    live = _liveness(pattern, n)
    p = _payload(n, rows, live, seed=n + rows)
    ref, ref_n = jax_partition.compact_live_payload(jnp.asarray(p))
    ref, ref_n = np.asarray(ref), int(ref_n)
    got, got_n = pt.compact_live_payload(
        torch.from_numpy(np.ascontiguousarray(p.T)))
    assert got_n.dtype == torch.int32 and got_n.dim() == 0
    got, got_n = got.numpy().T, int(got_n)
    assert got_n == ref_n == int(live.sum())
    np.testing.assert_array_equal(got[:, :got_n].view(np.int32),
                                  ref[:, :ref_n].view(np.int32))
    # stable: the live lanes in their original order (the prefix is all
    # the contract defines)
    np.testing.assert_array_equal(got[:, :got_n], p[:, live])


def test_ray_ids_survive_as_bit_patterns():
    """Field 6 carries int32 ray ids as raw bits (small ids are
    denormal floats): compaction must copy them untouched."""
    n = 3000
    p = torch.zeros((n, 8))
    p.view(torch.int32)[:, 6] = torch.arange(n, dtype=torch.int32)
    live = torch.arange(n) % 3 == 1
    p[:, 7] = torch.where(live, 1.0, -1.0)
    out, n_live = pt.compact_live_payload(p)
    assert int(n_live) == int(live.sum())
    assert torch.equal(out.view(torch.int32)[: int(n_live), 6],
                       torch.arange(n, dtype=torch.int32)[live])


def test_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        pt.compact_live_payload(torch.zeros((8, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        pt.compact_live_payload(torch.zeros((8, 6)))
    with pytest.raises(ValueError):
        pt.compact_live_payload(torch.zeros((16, 8)).t())


def test_cuda_tensors_never_take_plain_path(monkeypatch):
    """CPU tensors run the plain version, CUDA tensors the kernel's
    launch, any other device raises: no try/fallback between them."""
    calls = []
    real_plain = pt.partition_plain
    monkeypatch.setattr(pt, "partition_cuda",
                        lambda p: calls.append("cuda"))
    monkeypatch.setattr(pt, "partition_plain",
                        lambda p: calls.append("plain") or real_plain(p))
    launches = pt.launches
    pt.compact_live_payload(torch.zeros((4, 8)))
    assert calls == ["plain"] and pt.launches == launches

    class OnCard:
        device = torch.device("cuda", 0)

    pt.compact_live_payload(OnCard())
    assert calls == ["plain", "cuda"]
    with pytest.raises(ValueError, match="device"):
        pt.compact_live_payload(torch.zeros((4, 8), device="meta"))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        pt.partition_cuda(torch.zeros((4, 8)))


def _rays(case, n=3000, seed=21):
    """o, d, valid, t_limit (numpy) of one liveness case."""
    g = np.random.default_rng(seed)
    o = g.standard_normal((n, 3)).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    valid = (np.arange(n) * 2654435761 % 97) < 60
    t_limit = None
    if case == "all_live":
        valid[:] = True
    elif case == "all_dead":
        valid[:] = False
    elif case == "shadow":
        t_limit = g.uniform(0.0, 5.0, n).astype(np.float32)
        t_limit[::7] = 3e30  # above the 1e30 clamp
    elif case == "nan_negative":
        t_limit = g.uniform(-1.0, 1.0, n).astype(np.float32)
        t_limit[::5] = np.nan
        t_limit[::11] = -0.0  # >= 0: live, tub -0.0
    return o, d, valid, t_limit


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize(
    "case",
    ["closest", "shadow", "nan_negative", "all_dead", "all_live", "irregular"])
def test_ray_form_matches_payload_form(case):
    """compact_live_rays equals compact_live_payload(make_payload(...)):
    n_live equal, the live prefix equal to the bit (ray ids included)."""
    rays = tuple(_t(x) for x in _rays(case))
    got, got_n = pt.compact_live_rays(*rays)
    ref, ref_n = pt.compact_live_payload(wf.make_payload(*rays))
    assert got.shape == (rays[0].shape[0], 8)
    assert got_n.dtype == torch.int32 and got_n.dim() == 0
    k = int(got_n)
    assert k == int(ref_n)
    assert torch.equal(got[:k].view(torch.int32), ref[:k].view(torch.int32))
    want = {"all_dead": 0, "all_live": rays[0].shape[0]}.get(case)
    if want is not None:
        assert k == want
    else:
        assert 0 < k < rays[0].shape[0]


def test_ray_form_matches_pallas_partition(monkeypatch):
    """The ray form against the JAX partition kernel (interpret mode) of
    the same rays' [8, N] payload, on a shadow set with dead, NaN and
    negative bounds.  The JAX payload carries ray ids as float values
    (its lanes need not keep denormal bit patterns)."""
    monkeypatch.setattr(jax_partition, "_INTERPRET", True)
    o, d, valid, t_limit = _rays("nan_negative", n=2048)
    live = valid & (np.minimum(t_limit, np.float32(1e30)) >= 0)
    p = np.zeros((8, 2048), np.float32)
    p[0:3], p[3:6] = o.T, d.T
    p[6] = np.arange(2048)
    p[7] = np.where(valid, t_limit, -1.0)
    ref, ref_n = jax_partition.compact_live_payload(jnp.asarray(p))
    ref, k = np.asarray(ref), int(ref_n)
    got, got_n = pt.compact_live_rays(_t(o), _t(d), _t(valid), _t(t_limit))
    assert int(got_n) == k == int(live.sum())
    got = got.numpy()[:k]
    fields = [0, 1, 2, 3, 4, 5, 7]
    np.testing.assert_array_equal(got[:, fields].view(np.int32),
                                  ref[fields, :k].T.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32)[:, 6],
                                  ref[6, :k].astype(np.int32))


def test_ray_form_dispatch(monkeypatch):
    """CPU tensors run the ray form's plain version, CUDA tensors its
    kernel launch, any other device raises; the plain version is no
    launch."""
    calls = []
    real_plain = pt.compact_rays_plain
    monkeypatch.setattr(pt, "partition_rays_cuda",
                        lambda *a: calls.append("cuda"))
    monkeypatch.setattr(pt, "compact_rays_plain",
                        lambda *a: calls.append("plain") or real_plain(*a))
    launches = pt.ray_launches
    z = torch.zeros((4, 3))
    pt.compact_live_rays(z, z, torch.ones(4, dtype=torch.bool))
    assert calls == ["plain"] and pt.ray_launches == launches

    class OnCard:
        device = torch.device("cuda", 0)

    pt.compact_live_rays(OnCard(), z, None)
    assert calls == ["plain", "cuda"]
    with pytest.raises(ValueError, match="device"):
        pt.compact_live_rays(z.to("meta"), z, None)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        pt.partition_rays_cuda(z, z, torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError):
        pt.compact_live_rays(z, z, torch.ones(4))
