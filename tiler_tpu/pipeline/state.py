"""Encoder state: the dense-array replacement for the reference's object
graph (TTile pointers / TFrame / TKeyFrame classes, main.pas:152-246).

Everything is a flat numpy array with masks instead of pointer liveness;
device copies are made inside the steps that need them. Shapes:

  frames_rgb   [F, H, W, 3] u8     source pixels (screen-cropped)
  fs_pixels    [F, H, W, 3] u8     FS-posterized pixels (== frames at 8bpc)
  tm_*         [F, TH, TW]         tilemap (tile idx / palette / mirrors)
  stm_*        [F, TH, TW]         smoothed tilemap copy (Smooth step)
  tiles_rgb    [N, 8, 8, 3] u8     global tile RGB
  tiles_pal    [N, 8, 8] u8        global tile palette indices (dithered)
  tile_*       [N]                 per-tile flags/counters
  keyframes    [K, 2] i32          inclusive [start, end] frame ranges
  palettes_rgb [K, P, S, 3] u8     final per-keyframe palettes
  palette_centroids [K, P, 192]    k-means centroids kept for FrameTiling

Mirror convention: tiles_pal stores the zone-canonicalized orientation
(PrepareTileMirrors, main.pas:4049-4069 bakes mirrors in); tm_h/tm_v are
the EFFECTIVE mirrors to apply to the stored pixels when rendering. The
reference instead tracks tile-baked flags separately and XORs at save time
(main.pas:4715); folding the XOR into the tilemap at canonicalization time
produces the same bitstream with one convention everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import EncoderConfig
from ..constants import TILE_W

_split_tiles_jit = None
_slice_split_jit = None
_fill_gather_jit = None


@dataclasses.dataclass
class EncoderState:
    config: EncoderConfig
    fps: float = 24.0
    tilemap_w: int = 0
    tilemap_h: int = 0

    frames_rgb: Optional[np.ndarray] = None
    fs_pixels: Optional[np.ndarray] = None

    tm_tile: Optional[np.ndarray] = None   # int32
    tm_pal: Optional[np.ndarray] = None    # int32 (-1 until dithered)
    tm_h: Optional[np.ndarray] = None      # bool
    tm_v: Optional[np.ndarray] = None      # bool
    stm_tile: Optional[np.ndarray] = None
    stm_pal: Optional[np.ndarray] = None
    stm_h: Optional[np.ndarray] = None
    stm_v: Optional[np.ndarray] = None
    stm_smooth: Optional[np.ndarray] = None  # bool

    tiles_rgb: Optional[np.ndarray] = None
    _tiles_pal_host: Optional[np.ndarray] = None
    _tiles_pal_dev: object = None  # jax array mirror (see tiles_pal property)
    tile_active: Optional[np.ndarray] = None
    tile_use: Optional[np.ndarray] = None
    tile_dpi: Optional[np.ndarray] = None    # DitheringPalIndex

    keyframes: Optional[np.ndarray] = None
    palettes_rgb: Optional[np.ndarray] = None
    palette_centroids: Optional[np.ndarray] = None
    # [F, TH*TW] bool: cell differs from the same cell one frame earlier
    # (keyframe-start rows forced True). Computed once in load; drives
    # the motion-aware upload AND FrameTiling's temporal query dedup.
    changed_mask: Optional[np.ndarray] = None

    # optional jax.sharding.Mesh: when set (Encoder(mesh=...) or CLI
    # --devices N), the frame-axis-parallel stages run sharded across it
    # (parallel.mesh_pipeline). Not serialized by checkpoints — callers
    # re-attach after load.
    mesh: object = dataclasses.field(default=None, repr=False)

    step_times: dict = dataclasses.field(default_factory=dict)
    metrics: dict = dataclasses.field(default_factory=dict)
    _dev_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    _frames_dev_cache: dict = dataclasses.field(default_factory=dict,
                                                repr=False)
    _src_tiles_cache: dict = dataclasses.field(default_factory=dict,
                                               repr=False)

    def device_tiles_rgb(self):
        """tiles_rgb resident on device, uploaded once per array identity.
        When tiles_rgb is still the identity
        split of frames_rgb (true until Reindex permutes it), the tensor
        derives from the single frames upload instead of a second one."""
        key = ('tiles_rgb', id(self.tiles_rgb))
        if self._dev_cache.get('key') != key:
            import jax.numpy as jnp

            from ..utils.dispatch import note
            note('h2d')
            self._dev_cache = {'key': key,
                               'arr': jnp.asarray(self.tiles_rgb)}
        return self._dev_cache['arr']

    def device_frames(self):
        """frames_rgb resident on device, uploaded once per identity.

        The upload is CHUNKED (~12 MB pieces concatenated on device) and
        fully async: nothing blocks until a consumer reads the
        result (run_load starts the upload; the dither feature pass is
        the first consumer)."""
        cache, per = self._frame_parts()
        if 'arr' not in cache:
            import jax.numpy as jnp

            parts = self._resolve_parts(cache, 0, len(cache['futs']) - 1)
            if len(parts) > 1:
                from ..utils.dispatch import note
                note('eager')
                cache['arr'] = jnp.concatenate(parts)
            else:
                cache['arr'] = parts[0]
        return cache['arr']

    def _frame_parts(self):
        """The chunked async frame upload: per-~12MB device chunks plus
        the frames-per-chunk stride. Starts the upload on first call.

        Chunk SUBMISSION runs on a background thread: jnp.asarray can
        block once the transfer queue backs up, which would serialize load's host work (shot
        detection, tile split) behind the upload. Consumers resolve the
        futures they need — the per-keyframe dither prepare touches only
        its own keyframe's chunks."""
        key = ('frames_rgb', id(self.frames_rgb))
        if self._frames_dev_cache.get('key') != key:
            import concurrent.futures as cf

            import jax.numpy as jnp

            from ..utils.dispatch import note
            note('h2d')
            fr = self.frames_rgb
            per = max(1, 12_000_000 // max(fr[0].nbytes, 1))
            pool = cf.ThreadPoolExecutor(1)
            futs = [pool.submit(jnp.asarray, fr[i:i + per])
                    for i in range(0, len(fr), per)]
            pool.shutdown(wait=False)
            self._frames_dev_cache = {'key': key, 'futs': futs,
                                      'parts': [None] * len(futs),
                                      'per': per}
        c = self._frames_dev_cache
        for i, f in enumerate(c['futs']):
            if c['parts'][i] is None and f.done():
                c['parts'][i] = f.result()
        return c, c['per']

    @staticmethod
    def _resolve_parts(cache, lo: int, hi: int):
        """Device arrays for chunks [lo, hi] (inclusive), waiting on
        their submission futures only."""
        for i in range(lo, hi + 1):
            if cache['parts'][i] is None:
                cache['parts'][i] = cache['futs'][i].result()
        return cache['parts'][lo:hi + 1]

    # -- motion-aware source-tile upload -----------------------------------
    # The pipeline's only device pixel consumer is the source-tile tensor
    # (identity frame-major cell order). Cells byte-equal to the same
    # cell one frame earlier are EXACT duplicates, so only the changed
    # tiles ship (the same changed-mask FrameTiling's temporal query
    # dedup uses) and the full tensor reconstructs with ONE device
    # gather through a host-computed fill map — upload bytes scale with
    # motion, exactly like stage-3 assign cost. Keyframe-start rows are
    # forced changed so every keyframe's slice is self-contained (the
    # per-keyframe dither staging depends on it).

    def begin_tiles_upload(self, changed_mask: np.ndarray) -> None:
        """Start the chunked async changed-tiles upload. changed_mask is
        [F, TH*TW] bool with keyframe-start rows True (run_load forces
        them). Requires tiles_rgb (the host tile split) to be set."""
        key = ('tiles_up', id(self.frames_rgb))
        if self._frames_dev_cache.get('tiles_key') == key:
            return
        import concurrent.futures as cf

        import jax.numpy as jnp

        from ..utils.dispatch import note
        m = changed_mask.ravel()
        changed_idx = np.flatnonzero(m)
        f, cells = changed_mask.shape
        last = np.maximum.accumulate(
            np.where(changed_mask, np.arange(f)[:, None], -1), axis=0)
        changed_pos = np.cumsum(m) - 1
        src_flat = (last * cells + np.arange(cells)[None, :]).ravel()
        fill = changed_pos[src_flat].astype(np.int32)   # [F*C] -> row
        note('h2d')
        per = max(1, 12_000_000 // 192)     # ~12MB of 192-byte tiles
        n_up = -(-max(len(changed_idx), 1) // per) * per
        tiles_changed = np.zeros((n_up,) + self.tiles_rgb.shape[1:],
                                 np.uint8)
        tiles_changed[:len(changed_idx)] = self.tiles_rgb[changed_idx]
        pool = cf.ThreadPoolExecutor(1)
        futs = [pool.submit(jnp.asarray, tiles_changed[i:i + per])
                for i in range(0, n_up, per)]
        pool.shutdown(wait=False)
        c = self._frames_dev_cache
        c.update(tiles_key=key, t_futs=futs, t_parts=[None] * len(futs),
                 t_per=per, fill=fill, n_changed=len(changed_idx))
        self.metrics['upload_changed_frac'] = round(
            len(changed_idx) / max(len(m), 1), 4)

    @staticmethod
    def _resolve_tile_parts(cache, lo: int, hi: int):
        for i in range(lo, hi + 1):
            if cache['t_parts'][i] is None:
                cache['t_parts'][i] = cache['t_futs'][i].result()
        return cache['t_parts'][lo:hi + 1]

    def _reconstruct_tiles(self, s: int, e: int):
        """[ (e-s+1)*C, 8, 8, 3 ] source tiles for frames [s..e] from
        the changed-tile chunks covering them (None if the motion-aware
        upload is not active)."""
        c = self._frames_dev_cache
        if c.get('tiles_key') != ('tiles_up', id(self.frames_rgb)):
            return None
        import jax
        import jax.numpy as jnp

        from ..utils.dispatch import note
        cells = self.tilemap_size
        fill = c['fill'][s * cells:(e + 1) * cells]
        lo_row, hi_row = int(fill.min()), int(fill.max())
        per = c['t_per']
        lo, hi = lo_row // per, hi_row // per
        parts = self._resolve_tile_parts(c, lo, hi)
        note('h2d')
        note('jit')
        global _fill_gather_jit
        if _fill_gather_jit is None:
            import functools

            @functools.partial(jax.jit)
            def fill_gather(changed, fill_loc):
                return changed[fill_loc]
            _fill_gather_jit = fill_gather
        if len(parts) > 1:
            note('eager')
            src = jnp.concatenate(parts)
        else:
            src = parts[0]
        n_pad = 1 << max(8, (len(fill) - 1).bit_length())
        fill_p = np.zeros(n_pad, np.int32)
        fill_p[:len(fill)] = fill - lo * per
        return _fill_gather_jit(src, jnp.asarray(fill_p))[:len(fill)]

    def device_source_tiles_range(self, s: int, e: int):
        """[ (e-s+1)*TH*TW, 8, 8, 3] u8 source tiles of frames [s..e]
        (inclusive), built from only the upload chunks covering that
        range: a consumer (the per-keyframe dither prepare) blocks only
        on ITS keyframe's slice of the async H2D, so keyframe 0's
        k-means — and the host DL3 quantize it gates — start while the
        rest of the clip is still in flight."""
        key = (id(self.frames_rgb), s, e)
        cached = self._src_tiles_cache.get(key)
        if cached is not None:
            return cached
        if s == 0 and e == self.n_frames - 1:
            return self.device_source_tiles()
        rec = self._reconstruct_tiles(s, e)
        if rec is not None:
            self._src_tiles_cache[key] = rec
            return rec
        import jax
        import jax.numpy as jnp

        from ..utils.dispatch import note
        cache, per = self._frame_parts()
        lo, hi = s // per, e // per
        parts = self._resolve_parts(cache, lo, hi)  # chunks lo..hi
        note('jit')
        global _slice_split_jit
        if _slice_split_jit is None:
            import functools

            @functools.partial(jax.jit, static_argnames=('off', 'n_f'))
            def slice_split(fr, off: int, n_f: int):
                x = fr[off:off + n_f]
                f, hh, ww, _ = x.shape
                th, tw = hh // TILE_W, ww // TILE_W
                x = x.reshape(f, th, TILE_W, tw, TILE_W, 3)
                x = x.transpose(0, 1, 3, 2, 4, 5)
                return x.reshape(f * th * tw, TILE_W, TILE_W, 3)
            _slice_split_jit = slice_split
        if lo == hi:
            src = parts[0]
        else:
            note('eager')
            src = jnp.concatenate(parts)
        arr = _slice_split_jit(src, s - lo * per, e - s + 1)
        self._src_tiles_cache[key] = arr
        return arr

    def drop_source_tile_ranges(self) -> None:
        """Free the per-keyframe tile tensors (keep the full-clip one,
        which lives under the string keys 'key'/'arr' — review round 5:
        a tuple-key filter here dropped it too, forcing FrameTiling to
        rebuild the whole tensor every encode)."""
        full = {k: v for k, v in self._src_tiles_cache.items()
                if k in ('key', 'arr')}
        self._src_tiles_cache = full

    def device_source_tiles(self):
        """[F*TH*TW, 8, 8, 3] u8 SOURCE tiles (identity frame-major cell
        order, independent of the tilemap) — reconstructed from the
        motion-aware changed-tiles upload when active (one device
        gather), else built from the full frames upload. Feeds dither
        gathers and FrameTiling queries without shipping the pixels a
        second time."""
        key = ('src_tiles', id(self.frames_rgb))
        if self._src_tiles_cache.get('key') != key:
            rec = self._reconstruct_tiles(0, self.n_frames - 1) \
                if self.n_frames else None
            if rec is not None:
                self._src_tiles_cache = {'key': key, 'arr': rec}
                return rec
            import jax
            import jax.numpy as jnp
            global _split_tiles_jit
            if _split_tiles_jit is None:
                def split(fr):
                    f, hh, ww, _ = fr.shape
                    th, tw = hh // TILE_W, ww // TILE_W
                    x = fr.reshape(f, th, TILE_W, tw, TILE_W, 3)
                    x = x.transpose(0, 1, 3, 2, 4, 5)
                    return x.reshape(f * th * tw, TILE_W, TILE_W, 3)
                _split_tiles_jit = jax.jit(split)
            from ..utils.dispatch import note
            note('jit')
            self._src_tiles_cache = {
                'key': key, 'arr': _split_tiles_jit(self.device_frames())}
        return self._src_tiles_cache['arr']

    # -- tiles_pal host/device residency ------------------------------------
    # Between Dither and Reindex the dithered tiles stay ON DEVICE (no
    # [N,8,8] round trip); the host copy materializes lazily on
    # first .tiles_pal access. Exactly one side is authoritative: the
    # device mirror after set_tiles_pal_device(), the host array after the
    # setter ran or the property materialized it. Code that MUTATES the
    # host array in place must call drop_tiles_pal_dev() afterwards.

    @property
    def tiles_pal(self):
        if self._tiles_pal_host is None and self._tiles_pal_dev is not None:
            # np.array (copy): np.asarray of a jax array is read-only and
            # several consumers mutate the host tiles in place
            from ..utils.dispatch import note
            note('d2h')
            self._tiles_pal_host = np.array(self._tiles_pal_dev)
        return self._tiles_pal_host

    @tiles_pal.setter
    def tiles_pal(self, value):
        self._tiles_pal_host = value
        self._tiles_pal_dev = None

    def set_tiles_pal_device(self, arr) -> None:
        """Make the device array authoritative (host copy is stale)."""
        self._tiles_pal_dev = arr
        self._tiles_pal_host = None

    def peek_tiles_pal(self):
        """Read-only snapshot of tiles_pal that does NOT flip residency
        authority: serialization (checkpointing) must not silently switch
        later steps from the device path to the host path."""
        if self._tiles_pal_host is None and self._tiles_pal_dev is not None:
            return np.array(self._tiles_pal_dev)
        return self._tiles_pal_host

    def drop_tiles_pal_dev(self) -> None:
        """Invalidate the device mirror after in-place host mutation."""
        if self._tiles_pal_host is None and self._tiles_pal_dev is not None:
            self._tiles_pal_host = np.array(self._tiles_pal_dev)
        self._tiles_pal_dev = None

    def device_tiles_pal(self):
        """tiles_pal resident on device; uploads (and caches) from host
        when the host side is authoritative."""
        import jax.numpy as jnp
        if self._tiles_pal_dev is None:
            from ..utils.dispatch import note
            note('h2d')
            self._tiles_pal_dev = jnp.asarray(self._tiles_pal_host)
        return self._tiles_pal_dev

    @property
    def n_frames(self) -> int:
        return 0 if self.frames_rgb is None else len(self.frames_rgb)

    @property
    def tilemap_size(self) -> int:
        return self.tilemap_w * self.tilemap_h

    @property
    def screen_w(self) -> int:
        return self.tilemap_w * TILE_W

    @property
    def screen_h(self) -> int:
        return self.tilemap_h * TILE_W

    @property
    def n_tiles(self) -> int:
        if self._tiles_pal_host is not None:
            return len(self._tiles_pal_host)
        if self._tiles_pal_dev is not None:
            return self._tiles_pal_dev.shape[0]
        return 0

    def active_tile_count(self) -> int:
        return int(self.tile_active.sum())

    def kf_of_frame(self) -> np.ndarray:
        """[F] keyframe index per frame."""
        kf = np.zeros(self.n_frames, np.int32)
        for k, (s, e) in enumerate(self.keyframes):
            kf[s:e + 1] = k
        return kf
