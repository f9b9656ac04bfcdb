"""Multi-device distribution: device mesh + the production sharded scoring.

The reference's "parallelism" is a single-host subprocess farm over
(HMM x query-chunk) hmmsearch jobs (witch_msa/gcmm/algorithm.py:286-307,
SURVEY.md §2.4). Here queries are data-parallel over a 1-D device mesh
('data'; the cards of a host reach each other all to all, so the mesh
follows the algorithm alone), the eHMM bank is replicated (the whole
141-model example bank is ~8 MB), and every Forward pair is computed
exactly as on one device — so the sharded path is *bit-identical* to the
single-device path, and the downstream reported-score semantics (tau
gate, null2 bias, top-k weighting in pipeline.compute_scores /
weighting.calculate_weights) apply unchanged to the gathered [Q, H]
score matrix.  Scoring needs no collectives at all; the [Q, H] gather is
a few hundred KB.  The same sharding serves the null2 pass (per-pair
posterior/bias work in hmm/null2.py), which is the other device-heavy
stage of compute_scores.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..hmm.forward import _forward_one


def data_mesh(n_devices: Optional[int] = None) -> Optional[Mesh]:
    """1-D production mesh over all (or the first n) devices; None when
    only one device is available (single-chip path stays untouched)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if len(devs) <= 1:
        return None
    return Mesh(np.array(devs), ("data",))


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: Optional[int] = None) -> Mesh:
    """Factor devices into a (data, model) mesh (kept for experiments
    with bank sharding; the production scoring path uses data_mesh)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if model_parallel is None:
        model_parallel = 1
        for m in range(int(np.sqrt(n)), 0, -1):
            if n % m == 0:
                model_parallel = m
                break
    assert n % model_parallel == 0
    grid = np.array(devs).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, ("data", "model"))


def _local_bits(em, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
                codes, qlens):
    """Null1-corrected pre-score bits for a local query shard (XLA scan
    path — identical math to hmm.forward.forward_bits_bank)."""
    f_h = jax.vmap(_forward_one,
                   in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None, None))
    f_qh = jax.vmap(f_h, in_axes=(None,) * 9 + (0, 0))
    fwd = f_qh(em, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
               codes, qlens)
    L = qlens.astype(jnp.float32)
    p1 = L / (L + 1.0)
    null1 = (L * jnp.log(p1) + jnp.log(1.0 - p1)) / jnp.log(2.0)
    return fwd / jnp.log(2.0) - null1[:, None]


@functools.cache
def _sharded_xla_step(mesh):
    in_specs = (tuple([P()] * 9), P("data", None), P("data"))
    return jax.jit(jax.shard_map(
        lambda bank, c, l: _local_bits(*bank, c, l),
        mesh=mesh, in_specs=in_specs, out_specs=P("data", None),
        check_vma=False))


@functools.cache
def sharded_kernel_step(mesh, interpret: bool = False):
    """The Triton pre-score kernel under shard_map: query blocks over
    'data', model tables replicated (ops/pallas_forward.forward_bits
    takes it as its `step`)."""
    from ..ops.pallas_forward import forward_nats_blocks
    in_specs = (P("data", None, None), P("data", None), P("data"),
                P(), P(), P())
    return jax.jit(jax.shard_map(
        functools.partial(forward_nats_blocks, interpret=interpret),
        mesh=mesh, in_specs=in_specs,
        out_specs=P(None, "data", None), check_vma=False))


def sharded_score_bank(mesh: Mesh, bank, codes: np.ndarray,
                       qlens: np.ndarray, backend: str = "xla") -> np.ndarray:
    """Production distributed scoring: [Q, H] pre-score bits, queries
    sharded over 'data', bank replicated.  Per-pair computation is the
    single-device code — results are bit-identical to score_bank on one
    device (asserted by tests/test_parallel.py)."""
    n = int(mesh.shape["data"])
    Q = len(qlens)
    if backend == "pallas":
        from ..ops.pallas_forward import forward_bits
        return forward_bits(bank, codes, qlens,
                            step=sharded_kernel_step(mesh), n_shards=n)

    args = tuple(jnp.asarray(a) for a in (
        bank.em_odds, bank.t_mm, bank.t_mi, bank.t_md, bank.t_im,
        bank.t_ii, bank.t_dm, bank.t_dd, bank.bm))
    Qpad = -(-Q // n) * n
    cp = np.ones((Qpad, codes.shape[1]), np.int32)
    cp[:Q] = codes
    lp = np.ones(Qpad, np.int32)
    lp[:Q] = qlens
    step = _sharded_xla_step(mesh)
    bits = np.asarray(step(args, jnp.asarray(cp), jnp.asarray(lp)))
    return bits[:Q]


def replicate_bank_args(bank):
    return (bank.em_odds, bank.t_mm, bank.t_mi, bank.t_md, bank.t_im,
            bank.t_ii, bank.t_dm, bank.t_dd, bank.bm)


# ---------------------------------------------------------------------------
# End-to-end query sharding (multi-host pipeline distribution)
#
# The device mesh shards the *device* stages (Forward scoring). The host
# stages — reporting gate (native domaindef), per-query posterior/OA
# alignment, merge DP — are per-query independent, so a multi-host
# deployment shards the query list across hosts: each host gates and
# aligns only its owned shard, then the aligned rows are gathered to one
# host for the transitive merge (SURVEY.md §2.4/§5.8; the reference's
# analogue is the subprocess farm + filesystem bus,
# witch_msa/gcmm/results_handler.py:91-236).
# ---------------------------------------------------------------------------

def process_shard():
    """(shard, n_shards) for this process.

    Resolution order: WITCH_TPU_SHARD="i/n" (explicit; also how the
    single-process dryrun emulates n hosts), else JAX multi-process
    (jax.process_index/process_count), else (0, 1)."""
    import os
    spec = os.environ.get("WITCH_TPU_SHARD")
    if spec:
        i, n = spec.split("/")
        i, n = int(i), int(n)
        assert 0 <= i < n, "bad WITCH_TPU_SHARD %r" % spec
        return i, n
    try:
        import jax
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def shard_indices(Q: int, shard: int, n_shards: int) -> np.ndarray:
    """Owned query indices: contiguous balanced blocks (the same
    pad-to-multiple layout the P('data') device sharding uses, so a
    host's owned queries are the ones its local devices scored)."""
    per = -(-Q // n_shards)
    lo = min(Q, shard * per)
    return np.arange(lo, min(Q, lo + per))


def gather_rows(rows, ignored, shard: int, n_shards: int, outdir: str):
    """Gather per-shard aligned rows; returns (rows, ignored) on the
    merging host and None elsewhere.

    Real multi-host JAX (process_count > 1): all-gather over DCN of the
    utf-8-packed rows; host 0 merges. Single-process emulation (the
    WITCH_TPU_SHARD path used by dryrun_multichip and tests): shards
    stage rows under outdir and the last shard to complete merges."""
    import os

    try:
        import jax
        multi_process = jax.process_count() > 1
    except Exception:
        multi_process = False
    payload = _pack_rows(rows, ignored)
    if multi_process:
        from jax.experimental import multihost_utils
        buf = np.frombuffer(payload, np.uint8)
        n = np.array([buf.size], np.int64)
        sizes = np.asarray(multihost_utils.process_allgather(n)).ravel()
        pad = np.zeros(int(sizes.max()), np.uint8)
        pad[:buf.size] = buf
        all_bufs = np.asarray(multihost_utils.process_allgather(pad))
        if jax.process_index() != 0:
            return None
        rows_all, ignored_all = [], []
        for k in range(len(sizes)):
            r, i = _unpack_rows(all_bufs[k, :int(sizes[k])].tobytes())
            rows_all.extend(r)
            ignored_all.extend(i)
        return rows_all, ignored_all

    import gzip
    os.makedirs(outdir, exist_ok=True)
    mine = os.path.join(outdir, "rows_shard_%d_of_%d.bin.gz"
                        % (shard, n_shards))
    with gzip.open(mine, "wb") as f:
        f.write(payload)
    paths = [os.path.join(outdir, "rows_shard_%d_of_%d.bin.gz"
                          % (k, n_shards)) for k in range(n_shards)]
    if not all(os.path.exists(p) for p in paths):
        return None
    rows_all, ignored_all = [], []
    for p in paths:
        with gzip.open(p, "rb") as f:
            r, i = _unpack_rows(f.read())
        rows_all.extend(r)
        ignored_all.extend(i)
    return rows_all, ignored_all


def _pack_rows(rows, ignored) -> bytes:
    out = ["%d\t%d" % (len(rows), len(ignored))]
    for name, row in rows:
        out.append("%s\t%s" % (name, row))
    out.extend(ignored)
    return "\n".join(out).encode("utf-8")


def _unpack_rows(payload: bytes):
    lines = payload.decode("utf-8").split("\n")
    nr, ni = (int(x) for x in lines[0].split("\t"))
    rows = []
    for line in lines[1:1 + nr]:
        name, _, row = line.rpartition("\t")
        rows.append((name, row))
    return rows, lines[1 + nr:1 + nr + ni]
