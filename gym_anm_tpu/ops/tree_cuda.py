"""Tree-structured Newton-Raphson power flow as a CUDA kernel.

The XLA tree solver (:func:`gym_anm_tpu.ops.tree_nr.solve_pfe_tree`) runs
the level sweep of every NR iteration as a chain of small slice ops inside
a fixed-length ``lax.scan``.  ``tree_nr_cuda.cu`` runs the same solve as one
kernel: one thread per environment lane walks the elimination schedule,
builds the 2x2 Jacobian blocks on the fly and stops as soon as its own lane
has converged or diverged.  The math and stopping rule are those of the XLA
solver; float32 only.

This module packs the schedule, builds and loads the kernel library, and
wraps the FFI call.  :func:`tree_walk_reference` is the kernel's walk in
NumPy: the plain reference the CPU tests hold it to, since a CUDA kernel has
no interpret mode.

The library is compiled by ``nvcc`` at first use into ``build/cuda/`` at the
root of the checkout, keyed by a hash of the source, or ahead of time with
``python -m gym_anm_tpu.ops.tree_cuda``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess

import numpy as np

import jax
import jax.numpy as jnp

from .tree_nr import TreeInfo

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tree_nr_cuda.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(SOURCE))), "build", "cuda")
TARGET = "gym_anm_tree_nr"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

# Columns of the per-slot admittance table (tree_nr_cuda.cu k*).
YC_DIAG_RE, YC_DIAG_IM, YC_UP_RE, YC_UP_IM, YC_DOWN_RE, YC_DOWN_IM = range(6)
YC_COLS = 8
N_SCRATCH = 12  # per-lane [S, B] planes the kernel works in


@dataclasses.dataclass(frozen=True, eq=False)
class TreeSchedule:
    """The kernel's view of a radial network (host NumPy).

    Slot ``s`` is node ``s`` of the tree's elimination order (leaves first,
    children before parents).  ``par[s]`` is the parent's slot, or -1 when
    the parent is the slack bus; ``ycols[s]`` holds Y[bus, bus],
    Y[bus, parent] and Y[parent, bus] as (re, im) pairs."""

    n_bus: int
    par: np.ndarray  # [S] int32
    ycols: np.ndarray  # [S, 8] float64 (the kernel gets float32)
    busm1: np.ndarray  # [S] bus - 1 of each slot
    enum: np.ndarray  # [n_bus - 1] slot of bus b + 1

    @property
    def S(self) -> int:
        return int(self.par.shape[0])


def pack_schedule(tree: TreeInfo) -> TreeSchedule:
    """Pack a :class:`~gym_anm_tpu.ops.tree_nr.TreeInfo` for the kernel."""
    m = tree.bus.shape[0]
    yc = np.zeros((m, YC_COLS), np.float64)
    yc[:, YC_DIAG_RE], yc[:, YC_DIAG_IM] = tree.y_diag[:, 0], tree.y_diag[:, 1]
    yc[:, YC_UP_RE], yc[:, YC_UP_IM] = tree.y_up[:, 0], tree.y_up[:, 1]
    yc[:, YC_DOWN_RE], yc[:, YC_DOWN_IM] = tree.y_down[:, 0], tree.y_down[:, 1]
    par = np.where(tree.has_par, tree.par_eo, -1).astype(np.int32)
    return TreeSchedule(
        n_bus=tree.n_bus,
        par=par,
        ycols=yc,
        busm1=(tree.bus - 1).astype(np.int64),
        enum=np.asarray(tree.enum, np.int64),
    )


# ----------------------------------------------------------------------
# Plain reference of the kernel's per-lane walk.
# ----------------------------------------------------------------------
def tree_walk_reference(sched: TreeSchedule, p, q, x_tol=1e-5, max_iter=10, init=None, dtype=np.float32):
    """The kernel's algorithm in NumPy, slot by slot as each lane walks it.

    ``p, q``: [B, m] injections in bus order.  ``init``: optional warm
    start ``(theta, vm)`` [B, m] in bus order, taken per lane when its
    finite mismatch beats the flat start's.  Every lane iterates on its own
    until its mismatch inf-norm is <= ``x_tol``, it is NaN, or ``max_iter``
    steps are spent.  Returns ``(v_re [B, n], v_im [B, n], diff [B],
    n_iter [B])``."""
    dt = np.dtype(dtype)
    p = np.asarray(p, dt)
    q = np.asarray(q, dt)
    B = p.shape[0]
    S = sched.S
    par = sched.par
    y = sched.ycols.astype(dt)
    pT, qT = p.T[sched.busm1], q.T[sched.busm1]  # [S, B] slot order
    one, zero = dt.type(1), dt.type(0)

    def eval_point(th, vm):
        vr, vi = vm * np.cos(th), vm * np.sin(th)
        ir = np.zeros((S, B), dt)
        ii = np.zeros((S, B), dt)
        fp = np.empty((S, B), dt)
        fq = np.empty((S, B), dt)
        for s in range(S):
            ps = par[s]
            pr, pi = (vr[ps], vi[ps]) if ps >= 0 else (one, zero)
            cr = (y[s, 0] * vr[s] - y[s, 1] * vi[s]) + (y[s, 2] * pr - y[s, 3] * pi) + ir[s]
            ci = (y[s, 0] * vi[s] + y[s, 1] * vr[s]) + (y[s, 2] * pi + y[s, 3] * pr) + ii[s]
            ir[s], ii[s] = cr, ci
            if ps >= 0:
                ir[ps] += y[s, 4] * vr[s] - y[s, 5] * vi[s]
                ii[ps] += y[s, 4] * vi[s] + y[s, 5] * vr[s]
            fp[s] = (vr[s] * cr + vi[s] * ci) - pT[s]
            fq[s] = (vi[s] * cr - vr[s] * ci) - qT[s]
        with np.errstate(invalid="ignore"):
            diff = np.maximum(np.max(np.abs(fp), axis=0), np.max(np.abs(fq), axis=0))
        return vr, vi, ir, ii, fp, fq, diff

    def block(a, b, wre, wim, ure, uim):
        return [a * wim - b * wre, a * ure + b * uim, a * wre + b * wim, b * ure - a * uim]

    def upper(s, xr, xi, pr, pi):
        pmag = np.sqrt(pr * pr + pi * pi)
        pnr, pni = pr / pmag, pi / pmag
        wre, wim = y[s, 2] * pr - y[s, 3] * pi, y[s, 2] * pi + y[s, 3] * pr
        ure, uim = y[s, 2] * pnr - y[s, 3] * pni, y[s, 2] * pni + y[s, 3] * pnr
        return block(xr, xi, -wre, -wim, ure, uim)

    def newton_step(vr, vi, ir, ii, fp, fq):
        A = np.zeros((4, S, B), dt)  # accumulated Schur complements, then Dinv
        b = np.zeros((2, S, B), dt)  # accumulated rhs, then the effective rhs
        for s in range(S):
            ps = par[s]
            xr, xi = vr[s], vi[s]
            vmag = np.sqrt(xr * xr + xi * xi)
            vnr, vni = xr / vmag, xi / vmag
            cr, ci = ir[s], ii[s]
            yvr, yvi = y[s, 0] * xr - y[s, 1] * xi, y[s, 0] * xi + y[s, 1] * xr
            ure, uim = y[s, 0] * vnr - y[s, 1] * vni, y[s, 0] * vni + y[s, 1] * vnr
            D = block(xr, xi, cr - yvr, ci - yvi, ure, uim)
            D[1] = D[1] + (vnr * cr + vni * ci)
            D[3] = D[3] + (vni * cr - vnr * ci)
            d00, d01, d10, d11 = (D[k] - A[k, s] for k in range(4))
            b0, b1 = fp[s] - b[0, s], fq[s] - b[1, s]
            det = d00 * d11 - d01 * d10
            i00, i01, i10, i11 = d11 / det, -d01 / det, -d10 / det, d00 / det
            A[:, s] = i00, i01, i10, i11
            b[:, s] = b0, b1
            if ps >= 0:
                pr, pi = vr[ps], vi[ps]
                wre, wim = y[s, 4] * xr - y[s, 5] * xi, y[s, 4] * xi + y[s, 5] * xr
                lre, lim = y[s, 4] * vnr - y[s, 5] * vni, y[s, 4] * vni + y[s, 5] * vnr
                Lb = block(pr, pi, -wre, -wim, lre, lim)
                U = upper(s, xr, xi, pr, pi)
                m00, m01 = Lb[0] * i00 + Lb[1] * i10, Lb[0] * i01 + Lb[1] * i11
                m10, m11 = Lb[2] * i00 + Lb[3] * i10, Lb[2] * i01 + Lb[3] * i11
                A[0, ps] += m00 * U[0] + m01 * U[2]
                A[1, ps] += m00 * U[1] + m01 * U[3]
                A[2, ps] += m10 * U[0] + m11 * U[2]
                A[3, ps] += m10 * U[1] + m11 * U[3]
                b[0, ps] += m00 * b0 + m01 * b1
                b[1, ps] += m10 * b0 + m11 * b1
        dx = np.zeros((2, S, B), dt)
        for s in range(S - 1, -1, -1):
            ps = par[s]
            r0, r1 = b[0, s], b[1, s]
            if ps >= 0:
                U = upper(s, vr[s], vi[s], vr[ps], vi[ps])
                r0 = r0 - (U[0] * dx[0, ps] + U[1] * dx[1, ps])
                r1 = r1 - (U[2] * dx[0, ps] + U[3] * dx[1, ps])
            dx[0, s] = A[0, s] * r0 + A[1, s] * r1
            dx[1, s] = A[2, s] * r0 + A[3, s] * r1
        return dx

    with np.errstate(all="ignore"):
        th = np.zeros((S, B), dt)
        vm = np.ones((S, B), dt)
        point = eval_point(th, vm)
        if init is not None:
            th_w = np.asarray(init[0], dt).T[sched.busm1]
            vm_w = np.asarray(init[1], dt).T[sched.busm1]
            point_w = eval_point(th_w, vm_w)
            use_w = np.isfinite(point_w[-1]) & (point_w[-1] < point[-1])
            th = np.where(use_w, th_w, th)
            vm = np.where(use_w, vm_w, vm)
            point = tuple(np.where(use_w, w, f) for w, f in zip(point_w, point))
        it = np.zeros(B, np.int32)
        for _ in range(max_iter):
            active = point[-1] > x_tol  # NaN stops the lane
            if not active.any():
                break
            dx = newton_step(*point[:6])
            th = np.where(active, th - dx[0], th)
            vm = np.where(active, vm - dx[1], vm)
            new = eval_point(th, vm)
            point = tuple(np.where(active, n_, o_) for n_, o_ in zip(new, point))
            it += active
    vr, vi, diff = point[0], point[1], point[-1]
    v_re = np.concatenate([np.ones((1, B), dt), vr[sched.enum]]).T
    v_im = np.concatenate([np.zeros((1, B), dt), vi[sched.enum]]).T
    return v_re, v_im, diff, it


# ----------------------------------------------------------------------
# Build, load and call.
# ----------------------------------------------------------------------
def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "the CUDA tree-NR kernel needs nvcc (the CUDA toolkit) to build %s" % SOURCE
    )


def library_path() -> str:
    """Where the library for the current source lives (hash-keyed)."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, "libtree_nr_%s.so" % digest)


def build() -> str:
    """Compile the kernel library if it is not built yet; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.partial.%d" % (path, os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("building the CUDA tree-NR kernel failed:\n%s\n%s" % (" ".join(cmd), proc.stderr))
    os.replace(tmp, path)
    return path


_REGISTERED = False


def ensure_registered() -> None:
    """Build (if needed), load and register the kernel with XLA; raises on
    any failure, so a GPU solve never silently takes another path."""
    global _REGISTERED
    if _REGISTERED:
        return
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.GymAnmTreeNr), platform="CUDA")
    _REGISTERED = True


def _ffi_tree_nr(yc, par, pT, qT, th_w, vm_w, x_tol, max_iter, warm):
    """The raw FFI call on [S, B] slot-order operands (one device's lanes)."""
    S, B = pT.shape
    dt = jnp.float32
    call = jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct((S, B), dt),
            jax.ShapeDtypeStruct((S, B), dt),
            jax.ShapeDtypeStruct((B,), dt),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((N_SCRATCH, S, B), dt),
        ),
    )
    return call(
        yc, par, pT, qT, th_w, vm_w, x_tol=np.float32(x_tol), max_iter=np.int32(max_iter), warm=np.int32(warm)
    )


def lane_partitioned(raw):
    """Wrap ``raw(yc, par, pT, qT, th_w, vm_w, x_tol, max_iter, warm)`` so
    that under a device mesh each device solves its own lanes: the lane
    axis B keeps the sharding the operands arrive with, the schedule is
    replicated, and no collective is inserted.  Without this XLA would
    gather every lane onto every device around the opaque custom call."""
    from jax.experimental.custom_partitioning import custom_partitioning
    from jax.sharding import NamedSharding, PartitionSpec as P

    def shardings(mesh, arg_shapes):
        spec = arg_shapes[2].sharding.spec
        lane = spec[1] if len(spec) > 1 else None
        rep = NamedSharding(mesh, P())
        sb = NamedSharding(mesh, P(None, lane))
        b = NamedSharding(mesh, P(lane))
        ksb = NamedSharding(mesh, P(None, None, lane))
        return (rep, rep, sb, sb, sb, sb), (sb, sb, b, b, ksb)

    def partition(x_tol, max_iter, warm, mesh, arg_shapes, result_shape):
        args, outs = shardings(mesh, arg_shapes)

        def lower(*ops):
            return raw(*ops, x_tol, max_iter, warm)

        return mesh, lower, outs, args

    def infer(x_tol, max_iter, warm, mesh, arg_shapes, result_shape):
        return shardings(mesh, arg_shapes)[1]

    wrapped = custom_partitioning(raw, static_argnums=(6, 7, 8))
    wrapped.def_partition(
        partition,
        infer_sharding_from_operands=infer,
        sharding_rule="s c, s, s b, s b, s b, s b -> s b, s b, b, b, k s b",
        need_replication_factors=("s", "c", "k"),
    )
    return wrapped


_tree_nr_call = lane_partitioned(_ffi_tree_nr)


def solve_pfe_tree_cuda(sched: TreeSchedule, p, q, x_tol=1e-5, max_iter=10, init=None):
    """Batched tree-NR solve through the CUDA kernel.

    ``p, q``: [..., m] float32 non-slack injections in bus order (any batch
    shape; no multiple-of-anything requirement).  ``init`` optionally warm
    starts from previous bus voltages ``(v_re, v_im)`` [..., n].  Returns
    ``(v_re, v_im, diff, n_iter, converged)`` like
    :func:`~gym_anm_tpu.ops.tree_nr.solve_pfe_tree`.  Call under ``jit``.
    """
    ensure_registered()
    bshape = p.shape[:-1]
    m = p.shape[-1]
    B = int(np.prod(bshape)) if bshape else 1
    dt = jnp.float32
    pT = p.reshape(B, m).astype(dt).T[sched.busm1]  # [S, B] slot order
    qT = q.reshape(B, m).astype(dt).T[sched.busm1]
    warm = init is not None
    if warm:
        from .power_flow import warm_init_theta_vm

        n = m + 1
        th_b, vm_b, _ = warm_init_theta_vm(init[0].reshape(B, n), init[1].reshape(B, n), m, dt)
        th_w, vm_w = th_b[sched.busm1], vm_b[sched.busm1]
    else:
        th_w, vm_w = pT, qT  # not read by the kernel
    vr_s, vi_s, diff, n_iter, _ = _tree_nr_call(
        jnp.asarray(sched.ycols, dt), jnp.asarray(sched.par), pT, qT, th_w, vm_w, float(x_tol), int(max_iter), warm
    )
    v_re = jnp.concatenate([jnp.ones((1, B), dt), vr_s[sched.enum]]).T.reshape(bshape + (m + 1,))
    v_im = jnp.concatenate([jnp.zeros((1, B), dt), vi_s[sched.enum]]).T.reshape(bshape + (m + 1,))
    diff = diff.reshape(bshape)
    n_iter = n_iter.reshape(bshape)
    return v_re, v_im, diff, n_iter, diff <= x_tol


if __name__ == "__main__":
    print(build())
