"""Multi-stream fleet serving: data-parallel streams sharded over devices.

The reference is a single stateful object processing one video
(process_video.py:28-44).  Production serving runs many dashcam streams at
once; here each stream carries its own TrackerState and the whole fleet
steps in lockstep chunks:

    states:  pytree with leading (S,) axis, sharded over the 'stream' mesh axis
    frames:  (S, T, Hc, Wc, 3) uint8, sharded on S

The fleet step is a ``shard_map`` over the mesh: each device flattens its
local (S_local, T) frames into ONE (S_local*T) batch for the stateless
front half — exactly as in single-stream serving — and only the tiny
O(H)-per-frame back-half scan runs vmapped per stream.  Streams are
independent, so the only cross-device traffic is the final metrics psum.

(Vmapping whole chunk pipelines over streams instead turns the scanned
second-attempt lax.cond into an executed-both-sides O(H*W) re-filter.)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from lane_tracker_tpu.parallel.mesh import replicate, stream_mesh
from lane_tracker_tpu.tracker.config import TrackerConfig
from lane_tracker_tpu.tracker.step import (
    TrackerParams,
    back_half,
    front_artifacts_batch,
    make_initial_state,
    render_frame,
    second_attempt_artifacts_batch,
)
from lane_tracker_tpu.tracker.state import TrackerState


@functools.lru_cache(maxsize=16)
def build_fleet_processor(config: TrackerConfig, mesh,
                          with_overlay: bool = False,
                          second_attempt: str = "two_phase"):
    """jit fn: (states(S,...), frames(S,T,...), params) -> (states, outs, metrics).

    metrics is a dict of fleet-aggregated scalars (psum'd across the
    'stream' mesh axis).

    second_attempt: 'two_phase' (default) scans attempt-1 only and runs
    ONE device-level conditional batched fallback when some local frame
    failed — free in the steady state, but a failure-bearing chunk pays
    the batched attempt-2 front for the device's WHOLE local batch.
    'hoist' computes attempt-2 artifacts unconditionally up front —
    every chunk pays ~the attempt-2 filter, but failure-dense loads pay
    nothing extra (scripts/fleet_bench.py measures the crossover).
    """
    assert second_attempt in ("two_phase", "hoist"), second_attempt

    def fleet_local(states, frames, params):
        S, T = frames.shape[0], frames.shape[1]
        flat = frames.reshape((S * T,) + frames.shape[2:])
        arts = front_artifacts_batch(
            flat, params, config,
            hoist_second_attempt=second_attempt == "hoist",
        )
        arts_st = jax.tree_util.tree_map(
            lambda x: x.reshape((S, T) + x.shape[1:]), arts
        )

        def scan_all(sts, ar, cfg):
            def scan_one(st, art):
                def body(s, a):
                    s, out, meta = back_half(s, a, params, cfg)
                    return s, (out, meta)

                return jax.lax.scan(body, st, art)

            return jax.vmap(scan_one)(sts, ar)

        has_a2 = config.n_tries >= 2 or config.n_tries == -1
        if has_a2 and second_attempt == "hoist":
            # Unconditional hoist: attempt-2 artifacts were computed in
            # the batched front above; scan once with the full config.
            states, (outs, metas) = scan_all(states, arts_st, config)
        elif has_a2:
            # Two-phase conditional hoist: scan attempt-1 only; ONE
            # device-level lax.cond runs the batched attempt-2 front +
            # rescan only when some local frame failed.  In the steady
            # state (valid_fraction ~= 1) the fallback costs nothing,
            # where the unconditional hoist makes EVERY frame pay the
            # attempt-2 filter.  Devices diverge freely here (no
            # collective inside).
            cfg1 = dataclasses.replace(config, n_tries=1)
            states1, (outs1, metas1) = scan_all(states, arts_st, cfg1)
            all_valid = outs1.valid.all()

            def keep(_):
                return states1, (outs1, metas1)

            def fallback(_):
                pref2, iv2 = second_attempt_artifacts_batch(
                    arts.r_chan, arts.b_chan, params)
                full = arts_st._replace(
                    pref2=jax.tree_util.tree_map(
                        lambda x: x.reshape((S, T) + x.shape[1:]), pref2),
                    iv_sws2=jax.tree_util.tree_map(
                        lambda x: x.reshape((S, T) + x.shape[1:]), iv2),
                )
                return scan_all(states, full, config)

            states, (outs, metas) = jax.lax.cond(all_valid, keep, fallback,
                                                 None)
        else:
            states, (outs, metas) = scan_all(states, arts_st, config)
        if with_overlay:
            metas_flat = jax.tree_util.tree_map(
                lambda x: x.reshape((S * T,) + x.shape[2:]), metas
            )
            overlays = jax.vmap(
                lambda f, m: render_frame(f, m, params, config)
            )(flat, metas_flat)
            outs = outs._replace(
                overlay=overlays.reshape((S, T) + overlays.shape[1:])
            )
        local = {
            "frames": jnp.asarray(outs.valid.size, jnp.int32),
            "valid_frames": outs.valid.sum().astype(jnp.int32),
            "detected_frames": outs.detected.sum().astype(jnp.int32),
            "second_attempts": (outs.n_attempts > 1).sum().astype(jnp.int32),
        }
        metrics = jax.tree_util.tree_map(
            lambda x: jax.lax.psum(x, "stream"), local
        )
        return states, outs, metrics

    fn = jax.shard_map(
        fleet_local,
        mesh=mesh,
        in_specs=(P("stream"), P("stream"), P()),
        out_specs=(P("stream"), P("stream"), P()),
        check_vma=False,
    )
    return jax.jit(fn)


class StreamFleet:
    """Convenience driver for S concurrent streams on a device mesh."""

    def __init__(
        self,
        params: TrackerParams,
        config: TrackerConfig,
        n_streams: int,
        mesh=None,
        with_overlay: bool = False,
        second_attempt: str = "two_phase",
        auto_crossover: float = 0.81,
        auto_hysteresis: float = 0.05,
        auto_alpha: float = 0.25,
    ):
        """second_attempt: 'two_phase', 'hoist', or 'auto'.

        'auto' tracks the observed poisoned-step probability — the
        fraction of steps where ANY device's local batch contains an
        attempt-1 failure.  The metrics psum puts devices in lockstep,
        so a step's wall time is the max over devices: one poisoned
        device-chunk makes the whole fleet pay two_phase's fallback
        rate, which is why the indicator is any-over-devices, not the
        mean.  The controller keeps a host-side EMA of the per-step
        indicator and flips the schedule past ``auto_crossover``, the
        poisoned-step probability at which hoist's flat cost equals
        two_phase's mixed one.  The default 0.81 was measured on
        another device and is not yet re-measured on this one.
        Hysteresis keeps a load sitting on the boundary from thrashing;
        both schedules are bit-exact, so the flip never changes outputs,
        only cost.  A dead camera (P = 1) flips the fleet to hoist
        without operator action.
        """
        self.params = params
        self.config = config
        self.n_streams = int(n_streams)
        self.mesh = mesh if mesh is not None else stream_mesh()
        n_dev = self.mesh.shape["stream"]
        if self.n_streams % n_dev:
            raise ValueError(
                f"n_streams={n_streams} must divide over {n_dev} devices"
            )
        self.with_overlay = with_overlay
        if second_attempt not in ("two_phase", "hoist", "auto"):
            raise ValueError(
                f"unknown second_attempt {second_attempt!r}; expected "
                "'two_phase', 'hoist', or 'auto'")
        self._mode = second_attempt
        self.schedule = ("two_phase" if second_attempt == "auto"
                         else second_attempt)
        self._auto_crossover = float(auto_crossover)
        self._auto_hysteresis = float(auto_hysteresis)
        self._auto_alpha = float(auto_alpha)
        self.poison_ema = 0.0
        self._fn = build_fleet_processor(config, self.mesh, with_overlay,
                                         second_attempt=self.schedule)

        single = make_initial_state(config, params.warped_size)
        states = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (self.n_streams, *x.shape)), single
        )
        self.states = jax.tree_util.tree_map(
            lambda x: jax.device_put(
                x, NamedSharding(self.mesh, P("stream", *([None] * (x.ndim - 1))))
            ),
            states,
        )
        self.params_device = replicate(params, self.mesh)

    def frame_sharding(self):
        return NamedSharding(self.mesh, P("stream", None, None, None, None))

    def step(self, frames):
        """frames: (S, T, Hc, Wc, 3) uint8 (host or device)."""
        frames = jax.device_put(np.asarray(frames), self.frame_sharding())
        self.states, outs, metrics = self._fn(
            self.states, frames, self.params_device
        )
        if self._mode == "auto":
            self._auto_update(outs)
        return outs, metrics

    def _auto_update(self, outs):
        """EMA the observed poisoned-step rate and flip the schedule at
        the crossover (see __init__).  a1_valid is the
        attempt-1 outcome under BOTH schedules, so the observation is
        schedule-independent; the fetch is S*T bools per step."""
        a1 = np.asarray(outs.a1_valid)
        poisoned = float(not a1.all())
        self.poison_ema += self._auto_alpha * (poisoned - self.poison_ema)
        want = self.schedule
        if (self.schedule == "two_phase"
                and self.poison_ema > self._auto_crossover):
            want = "hoist"
        elif (self.schedule == "hoist"
              and self.poison_ema
              < self._auto_crossover - self._auto_hysteresis):
            want = "two_phase"
        if want != self.schedule:
            self.schedule = want
            self._fn = build_fleet_processor(
                self.config, self.mesh, self.with_overlay,
                second_attempt=want)
