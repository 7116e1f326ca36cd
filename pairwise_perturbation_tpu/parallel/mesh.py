"""Device-mesh layer: the JAX replacement for CTF's distributed tensor
runtime (SURVEY.md section 2.6).

CTF gives every ``Tensor<>`` an implicit cyclic block decomposition over
the MPI world and redistributes per contraction. Here the layout engine is
explicit and static:

- the input tensor V is block-sharded over its largest mode(s) via
  ``NamedSharding`` on a 1D or 2D ``Mesh`` (the mesh follows the
  algorithm: the cards of one host are joined all to all);
- factor matrices are row-sharded on sharded modes, replicated otherwise;
- every jitted sweep is GSPMD-partitioned by XLA: contractions over a
  sharded mode produce local partial MTTKRPs followed by a single
  ``psum``/``reduce_scatter`` (NCCL on GPUs) — the communication pattern
  CTF realizes with SUMMA + MPI reductions;
- an explicit ``shard_map`` MTTKRP (:func:`sharded_mttkrp`) demonstrates /
  pins the manual-collective path and is used to validate that the
  automatic partitioner produces the same results.

Zero-padding: sharded modes are padded to a multiple of the mesh axis.
Padding is algebraically invisible to ALS: padded slices of V are zero, so
padded rows of every MTTKRP (hence of every solved factor) stay zero, Gram
matrices are unchanged, and norms are unchanged.

Multi-process: :func:`distributed_init` wraps ``jax.distributed.initialize``
(one process per host); replaces ``MPI_Init`` + CTF ``World``
(test_ALS.cxx:58-60, 198-200). The cards of one host need none of it: one
process drives them all.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pairwise_perturbation_tpu.ops import contract


def distributed_init(single_host: bool = False, **kwargs):
    """Multi-host SPMD bring-up (replaces MPI_Init + CTF ``World``,
    test_ALS.cxx:58-60).

    A failed multi-host bring-up must be LOUD: silently degrading to
    single-host would run the job on 1/N of the machine while looking
    healthy. Pass ``single_host=True`` (or leave coordinator env/kwargs
    entirely unset) to explicitly run single-process.
    """
    import os
    wants_cluster = bool(kwargs) or any(
        os.environ.get(k) for k in
        ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"))
    if single_host or not wants_cluster:
        return  # explicit / implied single-host: nothing to initialize
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" in str(e).lower():
            return  # initialized earlier in this process — fine
        raise RuntimeError(
            "multi-host bring-up failed (coordinator configured via "
            f"{sorted(kwargs)} / env): {e}. Pass single_host=True to "
            "run single-process intentionally.") from e


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None,
              devices=None) -> Mesh:
    """Build a device mesh. Default: all devices on one axis 'x'."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = (n,)
    if axis_names is None:
        axis_names = tuple(f"x{i}" if i else "x"
                           for i in range(len(mesh_shape)))
    assert math.prod(mesh_shape) == n, (mesh_shape, n)
    dev_array = np.asarray(devices).reshape(mesh_shape)
    return Mesh(dev_array, tuple(axis_names))


@dataclass
class ShardedLayout:
    """Static layout decision: which tensor mode maps to which mesh axis."""
    mesh: Mesh
    mode_axis: dict            # tensor mode -> mesh axis name
    padded_shape: Tuple[int, ...]
    orig_shape: Tuple[int, ...]

    def v_spec(self) -> P:
        return P(*[self.mode_axis.get(m) for m in range(len(self.padded_shape))])

    def w_spec(self, mode: int) -> P:
        return P(self.mode_axis.get(mode), None)


def plan_layout(shape: Sequence[int], mesh: Mesh,
                modes: Optional[Sequence[int]] = None) -> ShardedLayout:
    """Map the largest tensor modes onto the mesh axes (largest mode to the
    largest axis) — the static analogue of CTF's per-contraction
    redistribution, chosen once so MTTKRP partials stay local until one
    reduction (SURVEY.md section 5 'long-context' note)."""
    shape = tuple(int(s) for s in shape)
    axes = sorted(mesh.shape.items(), key=lambda kv: -kv[1])  # (name, size)
    if modes is None:
        order_by_size = sorted(range(len(shape)), key=lambda m: -shape[m])
        modes = order_by_size[:len(axes)]
    mode_axis = {}
    padded = list(shape)
    for (axis, k), m in zip(axes, modes):
        mode_axis[m] = axis
        padded[m] = ((shape[m] + k - 1) // k) * k
    return ShardedLayout(mesh, mode_axis, tuple(padded), shape)


def shard_tensor(V, layout: ShardedLayout):
    """Zero-pad sharded modes and place V with its NamedSharding. A host
    (numpy) V goes to the devices slice by slice, so no device ever
    holds the whole tensor."""
    xp = np if isinstance(V, np.ndarray) else jnp
    pads = [(0, p - s) for s, p in zip(V.shape, layout.padded_shape)]
    if any(p != (0, 0) for p in pads):
        V = xp.pad(V, pads)
    return jax.device_put(V, NamedSharding(layout.mesh, layout.v_spec()))


def shard_factors(Ws: Sequence, layout: ShardedLayout):
    """Row-shard factors of sharded modes (zero-padded), replicate others."""
    out = []
    for m, W in enumerate(Ws):
        W = jnp.asarray(W)
        target = layout.padded_shape[m]
        if W.shape[0] < target:
            W = jnp.pad(W, ((0, target - W.shape[0]), (0, 0)))
        out.append(jax.device_put(W, NamedSharding(layout.mesh,
                                                   layout.w_spec(m))))
    return out


def unshard_factors(Ws: Sequence, layout: ShardedLayout):
    """Gather factors to host and strip padding rows."""
    return [np.asarray(W)[:layout.orig_shape[m], :]
            for m, W in enumerate(Ws)]


# ---------------------------------------------------------------------------
# Explicit-collective MTTKRP (shard_map + psum)
# ---------------------------------------------------------------------------


def sharded_mttkrp(V, Ws: Sequence, mode: int, layout: ShardedLayout):
    """MTTKRP with explicit per-shard partial contraction + psum.

    The contraction over each sharded mode j != mode is computed locally on
    each shard (V block x local rows of W_j) and reduced with one ``psum``
    over that mesh axis — the hand-written version of what GSPMD inserts.
    Kept as a reference/validation path.
    """
    mesh = layout.mesh
    v_spec = layout.v_spec()
    w_specs = [layout.w_spec(m) for m in range(len(Ws))]
    out_axis = layout.mode_axis.get(mode)
    reduce_axes = tuple(a for m, a in layout.mode_axis.items() if m != mode)

    def local(Vb, *Wbs):
        M = contract.mttkrp(Vb, list(Wbs), mode)
        if reduce_axes:
            M = jax.lax.psum(M, axis_name=reduce_axes)
        return M

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(v_spec, *w_specs),
                      out_specs=P(out_axis, None))
    return f(V, *Ws)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("single_specs", "pair_specs"))
def _constrained_build(V, Ws, single_specs, pair_specs):
    from jax.lax import with_sharding_constraint
    single, pair = contract.build_pp_caches(V, list(Ws))
    single = {i: with_sharding_constraint(x, single_specs[i])
              for i, x in single.items()}
    keys = sorted(pair)
    pair = {k: with_sharding_constraint(pair[k], s)
            for k, s in zip(keys, pair_specs)}
    return single, pair


def constrained_pp_caches(V, Ws: Sequence, layout: ShardedLayout):
    """PP cache build with explicit sharding constraints.

    SURVEY.md section 7 'hard parts': at scale the O(N^2/2) pair caches
    T_{ij}[s_i, s_j, R] dominate memory. Each cache keeps the sharding of
    its retained modes (same axes as V), so the later correction
    contractions T_{ij} x_j dW_j are local in the i-axis with a single
    reduction over j's axis — no resharding. GSPMD usually infers this;
    the constraint makes the layout deterministic.

    The jitted build is module-level with the (hashable) sharding specs
    as static args, so repeated cache rebuilds hit the jit cache instead
    of retracing per call.
    """
    mesh = layout.mesh
    order = len(Ws)
    single_specs = tuple(
        NamedSharding(mesh, P(layout.mode_axis.get(i), None))
        for i in range(order))
    # caches are rank-major (R, s_i, s_j) — replicate the rank axis
    pair_specs = tuple(
        NamedSharding(mesh, P(None, layout.mode_axis.get(i),
                              layout.mode_axis.get(j)))
        for i in range(order) for j in range(i + 1, order))
    return _constrained_build(V, list(Ws), single_specs, pair_specs)


# ---------------------------------------------------------------------------
# Mesh-sharded COO tensors (sparse V distributed by nonzeros)
# ---------------------------------------------------------------------------
#
# The reference's sparse CTF tensors are distributed over the MPI world
# like the dense ones (test_ALS.cxx:126-131, 229). JAX analogue:
# shard the COO arrays by NONZERO index (the only long axis), compute
# per-shard partial MTTKRPs / cache contributions locally, and reduce
# with one psum over the mesh — scatter-adds into replicated dense
# outputs commute with the nnz split, so partials are exact. Dense
# outputs (factor-sized matrices, pair caches of sparse-natural tensors)
# are small and stay replicated, mirroring the dense engine's
# replicated-factor layout.


def shard_coo(st, mesh: Mesh, axis: str = None):
    """Distribute a SparseTensor's nonzeros over the mesh (zero-padded to
    a multiple of the device count; padding entries carry value 0 at
    index 0, contributing nothing to any reduction)."""
    from pairwise_perturbation_tpu.ops import sparse as sp
    axis = axis or mesh.axis_names[0]
    n = mesh.shape[axis]
    total = math.prod(mesh.shape.values())
    if total != n:
        raise ValueError("shard_coo expects a 1D mesh (nnz axis only); "
                         f"got mesh shape {dict(mesh.shape)}")
    nnz = st.nnz
    pad = (-nnz) % n
    idx = jnp.pad(st.indices, ((0, pad), (0, 0)))
    val = jnp.pad(st.values, (0, pad))
    idx = jax.device_put(idx, NamedSharding(mesh, P(axis, None)))
    val = jax.device_put(val, NamedSharding(mesh, P(axis)))
    return sp.SparseTensor(idx, val, st.shape)


def _coo_axis(st, mesh: Mesh) -> str:
    return mesh.axis_names[0]


def sharded_sparse_mttkrp(st, Ws, mode: int, mesh: Mesh):
    """Exact sparse MTTKRP with per-shard partials + one psum."""
    from pairwise_perturbation_tpu.ops import sparse as sp
    axis = _coo_axis(st, mesh)

    def local(idx, val, *Wl):
        stl = sp.SparseTensor(idx, val, st.shape)
        return jax.lax.psum(sp.mttkrp(stl, list(Wl), mode), axis)

    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis)) + tuple(P(None, None)
                                                  for _ in Ws),
        out_specs=P(None, None))
    return f(st.indices, st.values, *Ws)


def sharded_sparse_pp_caches(st, Ws, mesh: Mesh):
    """PP cache build over the nnz-sharded COO: each shard runs the
    prefix/suffix chain build on its nonzeros (ops/sparse.build_pp_caches)
    and the dense outputs reduce with one psum — Build_mttkrp_map on a
    distributed sparse CTF tensor (als_CP.cxx:352-409)."""
    from pairwise_perturbation_tpu.ops import sparse as sp
    axis = _coo_axis(st, mesh)
    order = st.ndim

    def local(idx, val, *Wl):
        stl = sp.SparseTensor(idx, val, st.shape)
        single, pair = sp.build_pp_caches(stl, list(Wl))
        return jax.lax.psum((single, pair), axis)

    pair_keys = [(i, j) for i in range(order) for j in range(i + 1, order)]
    out_specs = ({i: P(None, None) for i in range(order)},
                 {k: P(None, None, None) for k in pair_keys})
    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis)) + tuple(P(None, None)
                                                  for _ in Ws),
        out_specs=out_specs)
    return f(st.indices, st.values, *Ws)


def sharded_sparse_ttmc(st, Ws, skip_mode: int, mesh: Mesh):
    """Sparse-first TTMc over the nnz-sharded COO: each shard contracts
    its nonzeros (ops/sparse.ttmc — one fused-index segment_sum + dense
    chain, all LINEAR in the values) and the dense results reduce with
    one psum. Exact because scatter-adds commute with the nnz split —
    the Tucker analogue of :func:`sharded_sparse_mttkrp`
    (als_Tucker.cxx TTMc on a distributed sparse CTF tensor)."""
    from pairwise_perturbation_tpu.ops import sparse as sp
    axis = _coo_axis(st, mesh)

    def local(idx, val, *Wl):
        stl = sp.SparseTensor(idx, val, st.shape)
        return jax.lax.psum(sp.ttmc(stl, list(Wl), skip_mode=skip_mode),
                            axis)

    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis)) + tuple(P(None, None)
                                                  for _ in Ws),
        out_specs=P(*([None] * st.ndim)))
    return f(st.indices, st.values, *Ws)


def sharded_sparse_ttmc_caches(st, Ws, mesh: Mesh):
    """Tucker PP cache build over the nnz-sharded COO: each shard runs
    the memoized sparse cache build on its nonzeros
    (ops/sparse.build_ttmc_caches) and the dense pair/single caches
    reduce with one psum — Build_ttmc_map on a distributed sparse
    tensor (als_Tucker.cxx:426-466)."""
    from pairwise_perturbation_tpu.ops import sparse as sp
    axis = _coo_axis(st, mesh)
    order = st.ndim

    def local(idx, val, *Wl):
        stl = sp.SparseTensor(idx, val, st.shape)
        single, pair = sp.build_ttmc_caches(stl, list(Wl))
        return jax.lax.psum((single, pair), axis)

    pair_keys = [(i, j) for i in range(order) for j in range(i + 1, order)]
    rep = P(*([None] * order))
    out_specs = ({i: rep for i in range(order)},
                 {k: rep for k in pair_keys})
    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis)) + tuple(P(None, None)
                                                  for _ in Ws),
        out_specs=out_specs)
    return f(st.indices, st.values, *Ws)


def sharded_sparse_gradnorm(st, Ws, mesh: Mesh, regul=None):
    """Exact CP gradnorm over the sharded nonzeros (per-mode partial
    MTTKRPs psum-reduced before the gradient assembly)."""
    from pairwise_perturbation_tpu.ops import contract
    total = jnp.asarray(0.0, Ws[0].dtype)
    for i in range(st.ndim):
        M = sharded_sparse_mttkrp(st, Ws, i, mesh)
        S = contract.hadamard_gram(list(Ws), skip_mode=i, regul=regul)
        g = contract.gradsubprob(M, S, Ws[i])
        total = total + contract.sum_sq([g])
    return jnp.sqrt(total)
