"""Quality/statistics kernels: Pearson correlation, PSNR, inter-frame
correlation for shot detection."""
from __future__ import annotations

import jax
import jax.numpy as jnp


def pearson(x, y):
    """PearsonCorrelation (main.pas:1465-1492) on flat float arrays."""
    x = x.astype(jnp.float32).ravel()
    y = y.astype(jnp.float32).ravel()
    xm = x - jnp.mean(x)
    ym = y - jnp.mean(y)
    num = jnp.sum(xm * ym)
    den = jnp.sqrt(jnp.sum(xm * xm)) * jnp.sqrt(jnp.sum(ym * ym))
    return jnp.where(den == 0, 0.0, num / den)


@jax.jit
def interframe_correlations(frames_u8):
    """Pearson correlation between consecutive frames
    (ComputeInterFrameCorrelation, main.pas:811-833), batched over the whole
    clip: frames [F, H, W, 3] uint8 -> [F-1] correlations.

    The reference arranges pixels plane-major before correlating; Pearson is
    invariant to that permutation, so we correlate the flat frames directly.
    """
    f = frames_u8.astype(jnp.float32).reshape(frames_u8.shape[0], -1)
    a, b = f[:-1], f[1:]
    am = a - jnp.mean(a, 1, keepdims=True)
    bm = b - jnp.mean(b, 1, keepdims=True)
    num = jnp.sum(am * bm, 1)
    den = jnp.sqrt(jnp.sum(am * am, 1)) * jnp.sqrt(jnp.sum(bm * bm, 1))
    return jnp.where(den == 0, 0.0, num / den)


def interframe_correlations_host(frames_u8) -> 'np.ndarray':
    """Host (numpy, float64) variant of interframe_correlations for the
    load step's shot detection: keyframe detection must not wait on the
    in-flight frames H2D (blocking on it here would serialize upload and
    compute). Each pair is computed
    independently, so feeding the clip in chunks (pipeline.stream)
    yields bit-identical values to the batch call."""
    import numpy as np
    n = len(frames_u8)
    out = np.empty(max(n - 1, 0), np.float64)
    flat = frames_u8.reshape(n, -1)
    prev = flat[0].astype(np.float64)
    prev -= prev.mean()
    prev_ss = float(prev @ prev)
    for i in range(1, n):
        cur = flat[i].astype(np.float64)
        cur -= cur.mean()
        cur_ss = float(cur @ cur)
        den = np.sqrt(prev_ss) * np.sqrt(cur_ss)
        out[i - 1] = 0.0 if den == 0 else float(prev @ cur) / den
        prev, prev_ss = cur, cur_ss
    return out


def psnr(a_u8, b_u8):
    """Peak signal-to-noise ratio between two uint8 images/clips."""
    a = jnp.asarray(a_u8, jnp.float32)
    b = jnp.asarray(b_u8, jnp.float32)
    mse = jnp.mean((a - b) ** 2)
    return jnp.where(mse == 0, jnp.inf, 10.0 * jnp.log10(255.0 ** 2 / mse))
