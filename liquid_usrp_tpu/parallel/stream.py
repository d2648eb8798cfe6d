"""Sharded stream processing: time-block (SP) and channel (TP) parallelism.

The device-mesh re-expression of the reference's concurrency (SURVEY.md §2.2):

* **Time-block sharding** — the stream is split into contiguous per-device
  chunks; each device receives the last ``overlap`` samples of its left
  neighbor via ``lax.ppermute`` (overlap-save halo = filter memory + max
  frame length) and runs the frame synchronizer *statelessly* on its
  extended chunk.  Every stream offset is detected by exactly one device, so
  results equal the sequential run.  This is the CP/ring analog of the
  reference's sample-serial carried state (msresamp/framesync `_execute`).
* **Channel sharding** — the per-channel synchronizers of the multichannel
  receiver are split across the ``channel`` mesh axis (the parallelization
  the reference leaves as a TODO at /root/reference/lib/
  multichannelrx.cc:184).  Within a device the local channels are vmapped.

Both compose on a 2-D ``('time', 'channel')`` mesh: each device analyzes its
time chunk (channelizer) and synchronizes its channel subset.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..framing import ofdm_sync
from ..models.multichannel import _center_offset
from ..ops import iqfmt
from ..ops import nco as nco_mod
from ..ops import pfb as pfb_mod

__all__ = ["make_time_sharded_sync", "make_sharded_mcrx",
           "make_sharded_mcrx_a2a", "sharded_mcrx", "make_sharded_mctx"]


def _sync_ops(sync):
    """``(block_fn, state_cls)`` for any streaming frame synchronizer.

    All three frame families share the ``(tail, base)`` carried-state
    contract and the ``block_fn(sync, state, block) -> (state', results)``
    step shape, so time sharding is family-agnostic.
    """
    if isinstance(sync, ofdm_sync.OfdmSync):
        return ofdm_sync.sync_block, ofdm_sync.OfdmSyncState
    from ..framing import flexframe_sync as ffs
    if isinstance(sync, ffs.FlexSync):
        return ffs.flex_sync_block, ffs.FlexSyncState
    from ..framing import gmskframe as gmskf
    if isinstance(sync, gmskf.GmskSync):
        return gmskf.gmsk_sync_block, gmskf.GmskSyncState
    from ..framing import wlan
    if isinstance(sync, wlan.WlanSync):
        return wlan.wlan_sync_block, wlan.WlanSyncState
    raise TypeError(f"unsupported synchronizer type {type(sync).__name__}")


def _scan_sync(sync, tail, base, stream, n_blocks):
    """Run ``n_blocks`` sequential sync blocks over ``stream`` via lax.scan."""
    block_fn, state_cls = _sync_ops(sync)
    state = state_cls(tail=tail, base=base)
    blocks = stream.reshape(n_blocks, sync.block_size)

    def body(st, blk):
        st, res = block_fn(sync, st, blk)
        return st, res

    state, results = jax.lax.scan(body, state, blocks)
    # results leaves: [n_blocks, max_frames, ...] -> flatten frame axis
    flat = jax.tree.map(
        lambda x: x.reshape((n_blocks * sync.max_frames,) + x.shape[2:]),
        results)
    return state, flat


def make_time_sharded_sync(mesh: jax.sharding.Mesh, sync,
                           chunk_blocks: int):
    """Jitted time-sharded synchronizer over mesh axis ``'time'``.

    ``sync`` may be any frame family's synchronizer (``OfdmSync``,
    ``FlexSync``, or ``GmskSync`` — see :func:`_sync_ops`); results are
    proven equal to the sequential scan for all three in
    ``tests/test_parallel.py``.  ``mesh`` must be 1-D with axis name
    ``'time'``.  Input: stream ``[n_time * chunk_blocks * block_size]``
    sharded over ``'time'``; output: results with leading axis ``n_time *
    chunk_blocks * max_frames`` (masked rows where nothing was detected).
    """
    n_time = mesh.shape["time"]
    B = sync.block_size * chunk_blocks
    halo = sync.overlap
    if B < halo:
        raise ValueError(
            f"per-device chunk ({B}) must cover the halo ({halo}); "
            "raise chunk_blocks or block_size")

    def shard_fn(x_local):
        x_local = x_local.reshape(-1)              # [B]
        t_idx = jax.lax.axis_index("time")
        # halo from left neighbor: everyone sends its tail to the right
        tail = x_local[B - halo:]
        left = jax.lax.ppermute(
            tail, "time", [(i, i + 1) for i in range(n_time - 1)])
        base = t_idx * B - halo
        state, res = _scan_sync(sync, left, base, x_local, chunk_blocks)
        return jax.tree.map(lambda v: v[None], res)  # add mapped time axis

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=P("time"),
                       out_specs=P("time"), check_vma=False)

    @jax.jit
    def run(stream):
        res = fn(stream)
        return jax.tree.map(
            lambda v: v.reshape((-1,) + v.shape[2:]), res)

    return run


def _make_regroup(N: int):
    """Host-side result regroup shared by both sharded receivers: leaves
    arrive ``[n_time, n_ch_shards, N_loc, rows, ...]`` from the mesh; a
    cross-shard transpose is not worth device collectives for result
    bookkeeping, so reorder on host to ``[N, n_time * rows, ...]``."""
    def fix(v):
        v = np.moveaxis(v, 0, 2)             # [n_ch, N_loc, n_time, rows, ..]
        return v.reshape((N, v.shape[2] * v.shape[3]) + v.shape[4:])
    return fix


def make_sharded_mcrx(mesh: jax.sharding.Mesh, num_channels: int,
                      sync: ofdm_sync.OfdmSync, chunk_blocks: int):
    """Channel- and time-sharded multichannel receiver.

    Input: mixture ``[n_time * chunk_blocks * block_size * 2N]`` sharded over
    ``'time'`` (replicated over ``'channel'``); each device channelizes its
    time chunk and synchronizes its ``N / n_channel_shards`` channels.
    Output: FrameResults with leading axes ``[time*blocks*frames, N]``
    flattened to rows.
    """
    N = num_channels
    n_time = mesh.shape["time"]
    n_ch = mesh.shape["channel"]
    if N % n_ch:
        raise ValueError(f"{N} channels not divisible by "
                         f"{n_ch} channel shards")
    N_loc = N // n_ch
    chz = pfb_mod.pfbch_create(2 * N, m=7, As=60.0)
    B = sync.block_size * chunk_blocks          # channel-samples per chunk
    halo = sync.overlap
    if B < halo:
        raise ValueError(
            f"per-device chunk ({B}) must cover the halo ({halo})")
    mix_B = 2 * N * B
    mix_halo = 2 * N * halo
    freq = -_center_offset(N)

    def shard_fn(x_local):
        x_local = x_local.reshape(-1)            # [mix_B]
        t_idx = jax.lax.axis_index("time")
        c_idx = jax.lax.axis_index("channel")
        tail = x_local[mix_B - mix_halo:]
        left = jax.lax.ppermute(
            tail, "time", [(i, i + 1) for i in range(n_time - 1)])
        ext = jnp.concatenate([left, x_local])   # [mix_halo + mix_B]
        # NCO with globally consistent phase: exact uint32 modular index
        # math (a float32 global index breaks past 2^24 samples)
        g0 = (t_idx.astype(jnp.uint32) * jnp.uint32(mix_B % (1 << 32))
              + jnp.uint32(-mix_halo % (1 << 32)))
        nco0 = nco_mod.nco_init_at(freq, g0)
        _, mixed = nco_mod.nco_mix_block(nco0, ext, up=True)
        _, X = pfb_mod.pfb_analyze_block(chz, pfb_mod.pfbch_state(chz),
                                         mixed)
        chans = jax.lax.dynamic_slice_in_dim(
            X, c_idx * N_loc, N_loc, axis=1).T   # [N_loc, halo + B]

        base = t_idx * B - halo

        # all local channels' candidates decode in one flat batch behind
        # one global gate — a vmapped per-channel scan turns the lax.cond
        # decode gate into an always-run select (see
        # ofdm_sync.sync_channels_batched)
        states = ofdm_sync.OfdmSyncState(
            tail=chans[:, :halo],
            base=jnp.full((N_loc,), base, jnp.int32))
        _, res = ofdm_sync.sync_channels_batched(
            sync, states,
            chans[:, halo:].reshape(N_loc, chunk_blocks, sync.block_size))
        res = jax.tree.map(
            lambda v: v.reshape(
                (N_loc, chunk_blocks * sync.max_frames) + v.shape[3:]),
            res)                                 # leaves [N_loc, rows, ...]
        return jax.tree.map(lambda v: v[None, None], res)

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=P("time"),
                       out_specs=P("time", "channel"),
                       check_vma=False)

    jit_fn = jax.jit(fn)

    fix = _make_regroup(N)

    def run(stream):
        res = jax.tree.map(np.asarray, jit_fn(stream))
        return jax.tree.map(fix, res)        # leaves [N, rows, ...]

    # multi-process callers (one process per host) drive the jitted fn on
    # a global array themselves, allgather, then regroup — see
    # scripts/multihost_worker.py
    run.jit_fn = jit_fn
    run.regroup = fix
    return run


def make_sharded_mcrx_a2a(mesh: jax.sharding.Mesh, num_channels: int,
                          sync: ofdm_sync.OfdmSync, chunk_blocks: int,
                          ingest: str = "c64", n_steps: int = 1):
    """All-to-all sharded multichannel receiver (no duplicated channelizer).

    The refinement of :func:`make_sharded_mcrx` for the >=80% scaling
    target (SURVEY.md §7 hard part 5): the mixture is split into
    ``n_time * n_ch`` *fine* time chunks over the flattened mesh so every
    device channelizes distinct samples (only a filter-memory halo is
    duplicated), then one ``all_to_all`` over the ``channel`` axis reshards
    channelizer output -> per-channel streams (the sequence<->heads
    transpose of the SDR domain), a ``ppermute`` over ``time`` provides the
    synchronizer overlap, and each device syncs its channel subset.

    Input: mixture ``[n_time * n_ch * chunk_blocks * block_size * 2N]``
    sharded over the flattened ``(time, channel)`` axes; output like
    :func:`make_sharded_mcrx` (leaves ``[N, rows, ...]``).

    ``ingest="bf16"`` takes the mixture as bfloat16 I/Q planes
    ``[2, total]`` (plane axis replicated, sample axis sharded) — half
    the per-device input HBM read; see ``ops/iqfmt.py``.

    ``n_steps > 1`` processes a longer stream as a **software-pipelined
    scan of super-steps** (docs/scaling.md "overlapped a2a"): each scan
    iteration runs super-step ``i``'s channelize + ``all_to_all`` and
    super-step ``i-1``'s frame sync, which are data-independent — XLA's
    latency-hiding scheduler can therefore run the collective behind
    the sync compute instead of serializing them.  Filter memory, NCO
    phase and sync overlap are carried across super-steps exactly (the
    wrap-around halos ride two tiny extra ``ppermute``\\ s), so the result
    equals the sequential receiver over the whole ``n_steps``-long stream
    (``tests/test_parallel.py::test_a2a_pipelined_matches_sequential``).
    Input shape: c64 ``[n_steps, n_dev * mix_sub]`` (each super-step row
    sharded over the flattened mesh); bf16 planes
    ``[n_steps, 2, n_dev * mix_sub]``.
    """
    N = num_channels
    n_time = mesh.shape["time"]
    n_ch = mesh.shape["channel"]
    if N % n_ch:
        raise ValueError(f"{N} channels not divisible by {n_ch} shards")
    N_loc = N // n_ch
    chz = pfb_mod.pfbch_create(2 * N, m=7, As=60.0)
    B_sub = sync.block_size * chunk_blocks      # channel-samples, fine chunk
    B_grp = B_sub * n_ch                        # channel-samples per time row
    halo = sync.overlap                         # sync overlap (channel-samp)
    ana_halo = 4 * chz.P                        # analysis filter memory
    if B_grp < halo:
        raise ValueError(
            f"time-row chunk ({B_grp}) must cover the sync halo ({halo})")
    if B_sub < ana_halo:
        raise ValueError(
            f"fine chunk ({B_sub} channel-samples) must cover the "
            f"analysis filter memory ({ana_halo}); raise chunk_blocks "
            f"or block_size")
    if ingest not in ("c64", "bf16"):
        raise ValueError(f"unknown ingest {ingest!r} (c64 or bf16)")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1 (got {n_steps})")
    mix_sub = 2 * N * B_sub
    freq = -_center_offset(N)
    planes = ingest == "bf16"
    n_dev = n_time * n_ch
    ana_tail_len = 2 * N * ana_halo

    def shard_fn(x_local):
        # normalize to [n_steps, mix_sub] complex64 device-local rows
        if planes:
            x = jax.vmap(iqfmt.iq_from_any)(
                x_local.reshape(n_steps, 2, mix_sub))
        else:
            x = x_local.reshape(n_steps, mix_sub)
        t_idx = jax.lax.axis_index("time")
        c_idx = jax.lax.axis_index("channel")
        flat = t_idx * n_ch + c_idx              # fine chunk index

        def stage_a(x_step, ana_tail_prev, sync_tail_prev, gstep):
            """Channelize + all_to_all for one super-step.

            ``ana_tail_prev`` / ``sync_tail_prev`` are this device's OWN
            tails from the previous super-step; the wrap-around links
            (combined-order device 0, time row 0) receive them via the
            single-pair ppermutes so stream continuity across super-steps
            is exact.  For step 0 they are zeros = stream start.
            """
            tail = x_step[mix_sub - ana_tail_len:]
            # analysis halo from the combined-order left neighbor
            left = jax.lax.ppermute(
                tail, ("time", "channel"),
                [(i, i + 1) for i in range(n_dev - 1)])
            left = left + jax.lax.ppermute(
                ana_tail_prev, ("time", "channel"), [(n_dev - 1, 0)])
            ext = jnp.concatenate([left, x_step])

            # NCO with globally consistent phase across devices AND
            # super-steps: exact uint32 modular index math
            gidx = (gstep * n_dev + flat).astype(jnp.uint32)
            g0 = (gidx * jnp.uint32(mix_sub % (1 << 32))
                  + jnp.uint32(-ana_tail_len % (1 << 32)))
            nco0 = nco_mod.nco_init_at(freq, g0)
            _, mixed = nco_mod.nco_mix_block(nco0, ext, up=True)
            _, X = pfb_mod.pfb_analyze_block(chz, pfb_mod.pfbch_state(chz),
                                             mixed)
            X = X[ana_halo:]                     # [B_sub, 2N] valid frames
            chans = X[:, :N]                     # [B_sub, N]

            # reshard: channels split over 'channel', fine-time gathered.
            # split axis 1 into n_ch groups, concatenate received pieces
            # along axis 0 (the c-ordered fine chunks of this time row).
            grp = jax.lax.all_to_all(
                chans.reshape(B_sub, n_ch, N_loc), "channel",
                split_axis=1, concat_axis=0, tiled=False)
            # grp: [n_ch(=fine chunks in c order), B_sub, N_loc] ->
            # time-major
            streams = grp.reshape(B_grp, N_loc).T    # [N_loc, B_grp]

            # sync halo from the previous time row (same channel group);
            # time row 0 wraps to the last row of the previous super-step
            s_tail = streams[:, B_grp - halo:]
            s_left = jax.lax.ppermute(
                s_tail, "time", [(i, i + 1) for i in range(n_time - 1)])
            s_left = s_left + jax.lax.ppermute(
                sync_tail_prev, "time", [(n_time - 1, 0)])
            return streams, s_left, tail, s_tail

        def stage_b(streams, s_left, gstep):
            base = (gstep * n_time + t_idx) * B_grp - halo
            # flat channels-x-blocks candidate batch, one decode gate
            # (see ofdm_sync.sync_channels_batched)
            states = ofdm_sync.OfdmSyncState(
                tail=s_left, base=jnp.full((N_loc,), base, jnp.int32))
            _, res = ofdm_sync.sync_channels_batched(
                sync, states,
                streams.reshape(N_loc, chunk_blocks * n_ch,
                                sync.block_size))
            return jax.tree.map(
                lambda v: v.reshape(
                    (N_loc, chunk_blocks * n_ch * sync.max_frames)
                    + v.shape[3:]), res)

        z_ana = jnp.zeros((ana_tail_len,), jnp.complex64)
        z_sync = jnp.zeros((N_loc, halo), jnp.complex64)
        streams0, s_left0, tail0, s_tail0 = stage_a(
            x[0], z_ana, z_sync, jnp.int32(0))

        def body(carry, inp):
            gstep, x_step = inp
            ana_tail, streams_p, s_left_p, s_tail_p = carry
            # stage A of step i and stage B of step i-1 share no data:
            # the a2a can run behind the sync compute (the overlap)
            streams_i, s_left_i, tail_i, s_tail_i = stage_a(
                x_step, ana_tail, s_tail_p, gstep)
            res_prev = stage_b(streams_p, s_left_p, gstep - 1)
            return (tail_i, streams_i, s_left_i, s_tail_i), res_prev

        carry0 = (tail0, streams0, s_left0, s_tail0)
        carry, res_scan = jax.lax.scan(
            body, carry0, (jnp.arange(1, n_steps, dtype=jnp.int32), x[1:]))
        res_last = stage_b(carry[1], carry[2], jnp.int32(n_steps - 1))
        res = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b[None]], axis=0),
            res_scan, res_last)                  # [n_steps, N_loc, rows,..]
        return jax.tree.map(lambda v: v[None, None], res)

    if planes:
        spec = (P(None, None, ("time", "channel")) if n_steps > 1
                else P(None, ("time", "channel")))
    else:
        spec = (P(None, ("time", "channel")) if n_steps > 1
                else P(("time", "channel")))
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=spec,
                       out_specs=P("time", "channel"),
                       check_vma=False)

    jit_fn = jax.jit(fn)

    def fix(v):
        # [n_time, n_ch, n_steps, N_loc, rows, ...] -> [N, total_rows, ...]
        # with global row order (step, time, row)
        v = np.transpose(v, (1, 3, 2, 0) + tuple(range(4, v.ndim)))
        return v.reshape((N, n_steps * n_time * v.shape[4])
                         + v.shape[5:])

    def run(stream):
        res = jax.tree.map(np.asarray, jit_fn(stream))
        return jax.tree.map(fix, res)        # leaves [N, rows, ...]

    run.jit_fn = jit_fn
    run.regroup = fix
    return run


# The all-to-all variant is the DEFAULT sharded multichannel receiver: it
# is the only one whose per-device channelizer work shrinks as the mesh
# grows (make_sharded_mcrx replicates the full-mixture channelization on
# every channel shard and exists as the simpler fallback / equivalence
# oracle).  See docs/scaling.md for the efficiency argument.
sharded_mcrx = make_sharded_mcrx_a2a


def make_sharded_mctx(mesh: jax.sharding.Mesh, num_channels: int,
                      chunk_samples: int):
    """All-to-all sharded multichannel TRANSMITTER — the synthesis dual of
    :func:`make_sharded_mcrx_a2a`.

    Frame generation is per-channel independent (each channel's
    ``assemble_frames`` batch shards over ``channel`` upstream of this
    op), so the input arrives channel-major: baseband streams ``[N, T]``
    with channels split over the ``channel`` mesh axis and time over
    ``time``.  One ``all_to_all`` transposes each device's
    ``[N_loc, n_ch * chunk]`` slab into ``[N, chunk]`` — every device
    then synthesizes a distinct *fine* time chunk of the mixture (the
    exact inverse reshard of the receiver).  The polyphase synthesizer's
    carried state is just its last ``P-1`` input frames, so a
    ``ppermute`` halo of ``P-1`` frames from the combined-order left
    neighbor reproduces the sequential filter memory exactly; the
    centering NCO phase is reconstructed per chunk from the global
    sample index with the exact uint32 DDS.

    Returns ``run(streams) -> mixture`` where ``streams`` is
    ``[N, n_time * n_ch * chunk_samples]`` per-channel baseband and
    ``mixture`` is ``[2N * n_time * n_ch * chunk_samples]`` — equal to
    the sequential ``make_mctx_step`` scan (tested on the virtual mesh).
    """
    N = num_channels
    n_time = mesh.shape["time"]
    n_ch = mesh.shape["channel"]
    if N % n_ch:
        raise ValueError(f"{N} channels not divisible by {n_ch} shards")
    chz = pfb_mod.pfbch_create(2 * N, m=13, As=60.0)
    halo_f = chz.P - 1                    # synthesis filter memory (frames)
    B_sub = int(chunk_samples)            # channel-samples per fine chunk
    if B_sub < halo_f:
        raise ValueError(
            f"chunk ({B_sub}) must cover the filter memory ({halo_f})")
    freq = _center_offset(N)
    n_dev = n_time * n_ch

    def shard_fn(s_local):
        # s_local: [N_loc, n_ch * B_sub] — this channel group's baseband
        # for this time row, fine chunks in c order along the time axis
        N_loc = s_local.shape[0]
        t_idx = jax.lax.axis_index("time")
        c_idx = jax.lax.axis_index("channel")
        flat = t_idx * n_ch + c_idx

        # transpose: channel groups -> fine time chunks.  split the time
        # row into n_ch fine chunks, exchange over 'channel', stack the
        # received channel groups -> all N channels of ONE fine chunk
        grp = jax.lax.all_to_all(
            s_local.reshape(N_loc, n_ch, B_sub), "channel",
            split_axis=1, concat_axis=0, tiled=False)
        grp = grp.reshape(N, B_sub)         # groups stack in channel order
        Y = jnp.zeros((B_sub, 2 * N), jnp.complex64)
        Y = Y.at[:, :N].set(grp.T)          # channels ride bins 0..N-1

        # synthesis filter memory: the previous fine chunk's last P-1
        # input frames, fetched over the combined (time, channel) order
        tail = Y[B_sub - halo_f:]
        left = jax.lax.ppermute(
            tail, ("time", "channel"),
            [(i, i + 1) for i in range(n_dev - 1)])
        ext = jnp.concatenate([left, Y])    # [halo_f + B_sub, 2N]
        _, y_ext = pfb_mod.pfb_synthesize_block(
            chz, pfb_mod.pfbch_state(chz), ext)
        y = y_ext[2 * N * halo_f:]          # [2N * B_sub] valid samples

        # centering NCO at the chunk's global output-sample index
        g0 = flat.astype(jnp.uint32) * jnp.uint32(
            (2 * N * B_sub) % (1 << 32))
        nco0 = nco_mod.nco_init_at(freq, g0)
        _, y = nco_mod.nco_mix_block(nco0, y, up=True)
        return y[None, None, :]

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=P("channel", "time"),
                       out_specs=P("time", "channel", None),
                       check_vma=False)
    jit_fn = jax.jit(fn)

    def run(streams):
        return np.asarray(jit_fn(streams)).reshape(-1)

    run.jit_fn = jit_fn
    return run
