"""Encoder orchestrator: the btnRunAllClick equivalent
(/root/reference/main.pas:1232-1272) with the reference's per-step
wall-time reporting (ProgressRedraw, main.pas:3581-3631).
"""
from __future__ import annotations

import time

import numpy as np

from ..config import EncoderConfig
from ..constants import ENCODER_STEPS, equal_quality_tile_count
from .state import EncoderState


class Encoder:
    def __init__(self, config: EncoderConfig | None = None, mesh=None):
        """mesh: optional jax.sharding.Mesh (parallel.mesh.make_mesh) —
        runs the frame-axis-parallel stages sharded across its devices
        with a byte-identical output stream (parallel.mesh_pipeline)."""
        from ..compile_cache import enable
        enable()
        self.config = config or EncoderConfig()
        self.state = EncoderState(config=self.config)
        self.state.mesh = mesh
        from ..utils.progress import StepProgress
        first = ENCODER_STEPS.index(self.config.start_step)
        last = ENCODER_STEPS.index(self.config.end_step)
        self.progress = StepProgress(ENCODER_STEPS[first:last + 1])

    # -- individual steps ---------------------------------------------------

    def load(self, frames: np.ndarray, fps: float | None = None):
        from .load import run_load
        return self._timed('load', run_load, self.state, frames, fps)

    def dither(self):
        from .dither_step import run_dither
        return self._timed('dither', run_dither, self.state)

    def make_unique(self):
        from .unique import run_make_unique
        return self._timed('make_unique', run_make_unique, self.state)

    def global_tiling(self):
        from .global_tiling import run_global_tiling
        return self._timed('global_tiling', run_global_tiling, self.state)

    def frame_tiling(self):
        from .frame_tiling import run_frame_tiling
        return self._timed('frame_tiling', run_frame_tiling, self.state)

    def reindex(self):
        from .reindex import run_reindex
        return self._timed('reindex', run_reindex, self.state)

    def smooth(self):
        from .smooth import run_smooth
        return self._timed('smooth', run_smooth, self.state)

    def save(self, fast_lzma: bool = False) -> bytes:
        from ..utils import dispatch
        from .save import run_save
        before = dispatch.snapshot()
        t0 = time.perf_counter()
        blob = run_save(self.state, fast_lzma=fast_lzma)
        self.state.step_times['save'] = time.perf_counter() - t0
        self.state.metrics.setdefault('dispatches', {})['save'] = \
            dispatch.delta(before)
        self._report('save')
        return blob

    # -- drivers ------------------------------------------------------------

    def max_tiles(self) -> int:
        cfg = self.config
        raw = self.state.n_frames * self.state.tilemap_size
        if cfg.max_tiles > 0:
            return min(cfg.max_tiles, raw)
        return min(round(cfg.qb_tiles * equal_quality_tile_count(raw)), raw)

    def run_all(self, frames: np.ndarray, fps: float | None = None,
                fast_lzma: bool = False,
                profile_dir: str | None = None,
                step_hook=None) -> bytes:
        """Full pipeline Load..Save honoring start/end step config.

        profile_dir: when set, wraps the run in a jax.profiler trace
        (the structured replacement for the reference's per-substep
        wall-clock prints, SURVEY.md §5.1).
        step_hook: optional callable(step_name) invoked after each
        completed step — the failure-recovery hook (the CLI's
        --auto-checkpoint persists the state there so a crashed encode
        resumes from the last completed step)."""
        if profile_dir:
            import jax
            with jax.profiler.trace(profile_dir):
                return self._run_all_inner(frames, fps, fast_lzma,
                                           step_hook)
        return self._run_all_inner(frames, fps, fast_lzma, step_hook)

    def _run_all_inner(self, frames: np.ndarray, fps: float | None,
                      fast_lzma: bool, step_hook=None) -> bytes:
        cfg = self.config
        first = ENCODER_STEPS.index(cfg.start_step)
        last = ENCODER_STEPS.index(cfg.end_step)

        def ok(step):
            return first <= ENCODER_STEPS.index(step) <= last

        def done(step):
            if step_hook is not None:
                step_hook(step)

        blob = b''
        if ok('load'):
            self.load(frames, fps)
            done('load')
        if ok('dither'):
            self.dither()
            done('dither')
        if ok('make_unique'):
            self.make_unique()
            done('make_unique')
        if ok('global_tiling'):
            self.global_tiling()
            done('global_tiling')
        if ok('frame_tiling'):
            self.frame_tiling()
            done('frame_tiling')
        if ok('reindex'):
            self.reindex()
            done('reindex')
        if ok('smooth'):
            self.smooth()
            done('smooth')
        if ok('save'):
            blob = self.save(fast_lzma=fast_lzma)
            done('save')
        self._sharded_wall_metric()
        return blob

    def _sharded_wall_metric(self) -> None:
        """Fraction of the DEVICE wall clock spent in mesh-shardable
        stages (the Amdahl number for multi-chip scaling): sharded =
        dither prepare+scan, FrameTiling mark/feats/assign, smooth (+
        the KModes solve under mesh_kmodes — reported separately as
        frac_with_kmodes); device wall excludes host-only phases (load,
        save, the DL3/VAR quantize pool, the KModes merge). Computed on
        every run: on a single-device run it is the PROJECTED coverage
        the mesh path shards (the stage set is static), on a mesh run
        the measured one."""
        st, m = self.state.step_times, self.state.metrics
        dp = m.get('dither_phases') or {}
        gp = m.get('gt_phases') or {}
        fp = m.get('ft_phases') or {}
        sharded = (dp.get('prepare_kmeans', 0.0) + dp.get('dither', 0.0)
                   + fp.get('mark', 0.0) + fp.get('cand_feats', 0.0)
                   + fp.get('assign', 0.0) + st.get('smooth', 0.0)
                   # round 5: MakeUnique (hash-partitioned all_to_all
                   # dedup, sharded_ops.sharded_unique — both the step
                   # and GlobalTiling's gt_unique rerun) and the GT
                   # signature build (signatures_sharded)
                   + st.get('make_unique', 0.0)
                   + gp.get('gt_unique', 0.0)
                   + gp.get('sigs_bins', 0.0))
        device_wall = (st.get('dither', 0.0) - dp.get('quantize', 0.0)
                       + st.get('make_unique', 0.0)
                       + st.get('global_tiling', 0.0)
                       - gp.get('merge_host', 0.0)
                       + st.get('frame_tiling', 0.0)
                       + st.get('smooth', 0.0) + st.get('reindex', 0.0))
        from ..parallel.mesh_pipeline import mesh_ok
        m['mesh_sharded_wall'] = {
            'sharded_s': round(sharded, 3),
            'device_wall_s': round(device_wall, 3),
            'frac': round(sharded / max(device_wall, 1e-9), 3),
            'frac_with_kmodes': round(
                (sharded + gp.get('solve', 0.0))
                / max(device_wall, 1e-9), 3),
            'measured_on_mesh': bool(mesh_ok(self.state.mesh)),
            'mesh_kmodes': bool(self.config.mesh_kmodes)}

    # -- internals ----------------------------------------------------------

    def _timed(self, name, fn, *args):
        from ..utils import dispatch
        before = dispatch.snapshot()
        t0 = time.perf_counter()
        result = fn(*args)
        self.state.step_times[name] = time.perf_counter() - t0
        self.state.metrics.setdefault('dispatches', {})[name] = \
            dispatch.delta(before)
        self._report(name)
        return result

    def _report(self, name):
        # reference-style step report (ProgressRedraw, main.pas:3622-3628)
        # + step-weighted percent/ETA (cEncoderStepLen, main.pas:61)
        t = self.state.step_times[name]
        total = sum(self.state.step_times.values())
        self.progress.finish_step(name)
        print(f'Step: {name:<14} Time: {t:8.3f}  All: {total:8.3f}  '
              f'{self.progress.format_suffix()}')
