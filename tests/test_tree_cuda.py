"""The CUDA tree-NR kernel's plain reference, schedule, wrapper and dispatch.

The kernel (ops/tree_nr_cuda.cu) runs only on an NVIDIA GPU.  On the CPU
these tests hold its NumPy twin (``tree_walk_reference``, the same per-lane
walk) to the XLA tree solver, check the packed schedule, drive the Python
wrapper through a stand-in for the FFI call, and pin the dispatch.  Tests
marked ``gpu`` run the kernel itself against both references.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gym_anm_tpu import check
from gym_anm_tpu.core.transition import resolve_solver_path, transition
from gym_anm_tpu.envs.anm6.anm6_easy import make_core as make_anm6
from gym_anm_tpu.envs.feeder33 import make_core as make_f33
from gym_anm_tpu.envs.feeder141 import make_core as make_f141
from gym_anm_tpu.ops import tree_cuda
from gym_anm_tpu.ops.tree_cuda import N_SCRATCH, pack_schedule, solve_pfe_tree_cuda, tree_walk_reference
from gym_anm_tpu.ops.tree_nr import build_tree_info, solve_pfe_tree

MAKERS = {"anm6easy": make_anm6, "feeder33": make_f33, "feeder141": make_f141}


def _setup(env, dtype):
    core = MAKERS[env](dtype=dtype)
    spec = core.spec
    tree = build_tree_info(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)
    return core, tree, pack_schedule(tree)


@pytest.mark.parametrize("env", list(MAKERS))
def test_walk_reference_matches_solve_pfe_tree(env):
    """In float64 the per-lane walk and the XLA level sweep are the same
    Newton iteration: same convergence decisions, same iteration counts,
    voltages to round-off."""
    core, tree, sched = _setup(env, jnp.float64)
    p, q = check.random_injections(core, 24, seed=2)
    tol, mi = core.x_tol, core.max_iter
    vr, vi, diff, it = tree_walk_reference(sched, p, q, tol, mi, dtype=np.float64)
    xr, xi, xd, xit, xc = jax.jit(lambda p, q: solve_pfe_tree(tree, p, q, x_tol=tol, max_iter=mi))(p, q)
    np.testing.assert_array_equal(diff <= tol, np.asarray(xc))
    np.testing.assert_array_equal(it, np.asarray(xit))
    ok = np.asarray(xc)
    np.testing.assert_allclose(vr[ok], np.asarray(xr)[ok], atol=1e-10)
    np.testing.assert_allclose(vi[ok], np.asarray(xi)[ok], atol=1e-10)


def test_walk_reference_warm_start():
    core, tree, sched = _setup("feeder33", jnp.float64)
    p, q = check.random_injections(core, 16, seed=3)
    vr, vi, diff, it = tree_walk_reference(sched, p, q, 1e-9, 20, dtype=np.float64)
    assert (diff <= 1e-9).all()
    th, vm = np.arctan2(vi[:, 1:], vr[:, 1:]), np.hypot(vr[:, 1:], vi[:, 1:])
    _, _, _, it_w = tree_walk_reference(sched, p, q, 1e-9, 20, init=(th, vm), dtype=np.float64)
    assert it_w.max() == 0
    # A warm point worse than flat is not taken: the cold solve reproduces.
    far = (np.full_like(th, 3.0), np.full_like(vm, 0.3))
    vr3, _, _, it3 = tree_walk_reference(sched, p, q, 1e-9, 20, init=far, dtype=np.float64)
    np.testing.assert_array_equal(it3, it)
    np.testing.assert_array_equal(vr3, vr)


@pytest.mark.parametrize("env", list(MAKERS))
def test_schedule_packing_invariants(env):
    core, tree, sched = _setup(env, jnp.float32)
    spec = core.spec
    m = spec.n_bus - 1
    S = sched.S
    assert S == m and sched.par.dtype == np.int32 and sched.ycols.shape == (S, 8)
    assert sched.ycols.dtype == np.float64
    # Every non-slack bus in exactly one slot; enum inverts busm1.
    np.testing.assert_array_equal(np.sort(sched.busm1), np.arange(m))
    np.testing.assert_array_equal(sched.enum[sched.busm1], np.arange(S))
    # Children precede parents: the kernel's ascending walk relies on it.
    assert all(sched.par[s] == -1 or sched.par[s] > s for s in range(S))
    Y = np.asarray(spec.Y_re, np.float64) + 1j * np.asarray(spec.Y_im, np.float64)
    for s in range(S):
        b = int(sched.busm1[s]) + 1
        pb = int(sched.busm1[sched.par[s]]) + 1 if sched.par[s] >= 0 else 0
        assert Y[b, pb] != 0  # the parent is a neighbour
        yc = sched.ycols[s]
        assert yc[0] + 1j * yc[1] == Y[b, b]
        assert yc[2] + 1j * yc[3] == Y[b, pb]
        assert yc[4] + 1j * yc[5] == Y[pb, b]
    # Each node has exactly one parent: branch count = m.
    assert (sched.par >= -1).all() and np.asarray(spec.br_f).shape[0] == m


def _stand_in(sched):
    """The FFI call's ABI ([S, B] slot-order operands) served by the NumPy
    walk through a host callback, so the wrapper runs on the CPU."""

    def call(yc, par, pT, qT, th_w, vm_w, x_tol, max_iter, warm):
        S, B = pT.shape

        def host(pT, qT, th_w, vm_w):
            p, q = np.asarray(pT)[sched.enum].T, np.asarray(qT)[sched.enum].T
            init = (np.asarray(th_w)[sched.enum].T, np.asarray(vm_w)[sched.enum].T) if warm else None
            vr, vi, d, it = tree_walk_reference(sched, p, q, x_tol, max_iter, init=init)
            slot = lambda v: np.ascontiguousarray(v[:, 1:].T[sched.busm1], np.float32)
            return (slot(vr), slot(vi), d.astype(np.float32), it.astype(np.int32),
                    np.zeros((N_SCRATCH, S, B), np.float32))

        shapes = (
            jax.ShapeDtypeStruct((S, B), jnp.float32),
            jax.ShapeDtypeStruct((S, B), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((N_SCRATCH, S, B), jnp.float32),
        )
        return jax.pure_callback(host, shapes, pT, qT, th_w, vm_w)

    return call


@pytest.fixture
def wrapper_on_cpu(monkeypatch):
    def install(sched):
        monkeypatch.setattr(tree_cuda, "_tree_nr_call", _stand_in(sched))
        monkeypatch.setattr(tree_cuda, "ensure_registered", lambda: None)

    return install


@pytest.mark.parametrize("B", [64, 4097])
def test_wrapper_tail_batches(B, wrapper_on_cpu):
    """The wrapper's layout (bus order -> slot order, batch last, back) is
    exact for any batch, including one past a block multiple."""
    core, tree, sched = _setup("anm6easy", jnp.float32)
    wrapper_on_cpu(sched)
    p, q = check.random_injections(core, B, seed=4)
    tol, mi = core.x_tol, core.max_iter
    vr, vi, d, it, conv = jax.jit(lambda p, q: solve_pfe_tree_cuda(sched, p, q, x_tol=tol, max_iter=mi))(p, q)
    rvr, rvi, rd, rit = tree_walk_reference(sched, p, q, tol, mi)
    np.testing.assert_array_equal(np.asarray(vr), rvr)
    np.testing.assert_array_equal(np.asarray(vi), rvi)
    np.testing.assert_array_equal(np.asarray(it), rit)
    np.testing.assert_array_equal(np.asarray(conv), rd <= tol)
    # ...and agrees with the XLA solver in float32 at the solver tolerances
    # the on-card check uses (gym_anm_tpu/check.py).
    xo = jax.jit(lambda p, q: solve_pfe_tree(tree, p, q, x_tol=tol, max_iter=mi))(p, q)
    res = check.compare_solves((vr, vi, d, it), xo[:4], tol)
    assert res["pass"], res


@pytest.mark.parametrize("shape", [(), (2, 3)])
def test_wrapper_batch_shapes(shape, wrapper_on_cpu):
    core, tree, sched = _setup("anm6easy", jnp.float32)
    wrapper_on_cpu(sched)
    n = int(np.prod(shape)) if shape else 1
    p, q = check.random_injections(core, n, seed=5)
    m = p.shape[1]
    pr, qr = p.reshape(shape + (m,)), q.reshape(shape + (m,))
    vr, vi, d, it, conv = jax.jit(lambda p, q: solve_pfe_tree_cuda(sched, p, q))(pr, qr)
    assert vr.shape == shape + (m + 1,) and d.shape == shape and conv.shape == shape
    rvr, _, rd, _ = tree_walk_reference(sched, p, q, 1e-5, 10)
    np.testing.assert_array_equal(np.asarray(vr).reshape(n, m + 1), rvr)
    np.testing.assert_array_equal(np.asarray(d).reshape(n), rd)


def test_wrapper_warm_start(wrapper_on_cpu):
    core, tree, sched = _setup("feeder33", jnp.float32)
    wrapper_on_cpu(sched)
    p, q = check.random_injections(core, 32, seed=6)
    f = jax.jit(lambda p, q, init: solve_pfe_tree_cuda(sched, p, q, x_tol=1e-5, max_iter=10, init=init))
    vr, vi, _, it, conv = f(p, q, None)
    vr2, _, _, it2, conv2 = f(p, q, (vr, vi))
    # Warm from the solution: (theta, |V|) recomputed in float32 may sit just
    # above x_tol, so at most one more step.
    assert int(np.asarray(it2)[np.asarray(conv)].max()) <= 1
    np.testing.assert_array_equal(np.asarray(conv2), np.asarray(conv))
    # Absorbing zero states fail the warm window and flat-start.
    vr3, _, _, it3, _ = f(p, q, (jnp.zeros_like(vr), jnp.zeros_like(vi)))
    np.testing.assert_array_equal(np.asarray(it3), np.asarray(it))
    np.testing.assert_array_equal(np.asarray(vr3), np.asarray(vr))


@pytest.mark.parametrize(
    "backend, dtype, pf_method, expected",
    [
        ("gpu", np.float32, "tree", "cuda_tree"),
        ("gpu", np.float64, "tree", "xla_tree"),
        ("gpu", np.float32, "tree_xla", "xla_tree"),
        ("cpu", np.float32, "tree", "xla_tree"),
        ("gpu", np.float32, "hybrid", "xla"),
    ],
)
def test_dispatch_by_backend_and_dtype(backend, dtype, pf_method, expected, monkeypatch):
    core = make_f33(dtype=dtype)
    spec = core.spec
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    probe = (np.zeros((8, spec.n_des), dtype), np.zeros((8, spec.n_load), dtype))
    assert resolve_solver_path(spec, pf_method, *probe) == expected


def test_gpu_without_library_raises(monkeypatch, tmp_path):
    """On a GPU a library that cannot be built is an error, never a quiet
    fallback to the XLA solver."""

    def no_toolkit():
        raise RuntimeError("the CUDA tree-NR kernel needs nvcc")

    core = make_anm6(dtype=jnp.float32)
    spec = core.spec
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(tree_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tree_cuda, "_REGISTERED", False)
    monkeypatch.setattr(tree_cuda, "_nvcc", no_toolkit)
    z = lambda n: jnp.zeros((4, n), jnp.float32)
    with pytest.raises(RuntimeError, match="nvcc"):
        jax.jit(
            lambda: transition(
                spec, z(spec.n_des), z(spec.n_load), z(spec.n_gen), z(spec.n_gen), z(spec.n_gen),
                z(spec.n_des), z(spec.n_des), pf_method="tree",
            )
        ).lower()


@pytest.mark.parametrize("pf_method", ["pallas", "fused", "xla_hybrid"])
def test_removed_pf_methods_rejected(pf_method):
    spec = make_f33().spec
    probe = (np.zeros((8, spec.n_des)), np.zeros((8, spec.n_load)))
    with pytest.raises(ValueError, match="pf_method"):
        resolve_solver_path(spec, pf_method, *probe)


def test_lane_partitioned_keeps_lanes_local():
    """Under a 1-D mesh the custom call runs on each device's own lanes: no
    collective, results equal the unsharded call."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    def raw(yc, par, pT, qT, th_w, vm_w, x_tol, max_iter, warm):
        S, B = pT.shape
        return (pT * 2 + yc[:, :1] + par[:, None], qT + 1, pT.sum(0) * x_tol,
                jnp.full((B,), max_iter + warm, jnp.int32), jnp.zeros((N_SCRATCH, S, B), jnp.float32))

    f = tree_cuda.lane_partitioned(raw)
    S, B = 5, 32
    yc = jnp.ones((S, 8), jnp.float32)
    par = jnp.arange(S, dtype=jnp.int32)
    p = jnp.arange(B * S, dtype=jnp.float32).reshape(B, S)

    def solve(p):
        out = f(yc, par, p.T, p.T, p.T, p.T, 0.5, 7, True)
        return out[0].T, out[2], out[3]

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("dp",))
    ps = jax.device_put(p, NamedSharding(mesh, P("dp")))
    j = jax.jit(solve)
    for a, b in zip(solve(p), j(ps)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    hlo = j.lower(ps).compile().as_text()
    assert not any(c in hlo for c in ("all-gather", "all-reduce", "all-to-all", "collective-permute"))


@pytest.mark.gpu
@pytest.mark.parametrize("env", list(MAKERS))
def test_kernel_matches_references_on_gpu(env, gpu):
    """The kernel against the XLA tree solver in float32 on the host CPU and
    the float64 walk, same injections, full width; tolerances and their
    reasons are chip_smoke.py's."""
    core, tree, sched = _setup(env, jnp.float32)
    tol, mi = core.x_tol, core.max_iter
    assert resolve_solver_path(core.spec, "tree", np.zeros((1, 1), np.float32), np.zeros((1, 1), np.float32)) == "cuda_tree"
    p, q = check.random_injections(core, 4096, seed=7)
    out = jax.jit(lambda p, q: solve_pfe_tree_cuda(sched, p, q, x_tol=tol, max_iter=mi))(p, q)
    got = tuple(np.asarray(x) for x in out[:4])
    with jax.default_device(jax.devices("cpu")[0]):
        xo = jax.jit(lambda p, q: solve_pfe_tree(tree, p, q, x_tol=tol, max_iter=mi))(p, q)
    for ref in (xo[:4], tree_walk_reference(sched, p, q, tol, mi, dtype=np.float64)):
        res = check.compare_solves(got, ref, tol)
        assert res["pass"], res
