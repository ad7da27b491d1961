"""Codec-wide constants.

These mirror the reference encoder's tweakable/fixed constants
(the reference's main.pas:17-98) but are re-derived here for an array
implementation: everything that was a Pascal LUT becomes a NumPy
array built once at import and shipped to the device as needed.
"""
from __future__ import annotations

import numpy as np

# --- tile geometry (main.pas:42-44) ---
TILE_W = 8
COLOR_CPNS = 3
TILE_PIXELS = TILE_W * TILE_W
TILE_DCT_SIZE = COLOR_CPNS * TILE_PIXELS  # 192

# --- Rec.709 luma weights (main.pas:24-37) ---
RED_MUL = 2126
GREEN_MUL = 7152
BLUE_MUL = 722
LUMA_DIV = RED_MUL + GREEN_MUL + BLUE_MUL
RGB_W = 13  # luma-vs-chroma weight used by ColorCompare (main.pas:33)

# --- misc knob constants (main.pas:20-47) ---
BITS_PER_COMP = 8
RANDOM_KMODES_COUNT = 7
FT_PALETTE_TOL = 0.05
SMOOTHING_PREV_FRAME = 1
PHI = (1 + np.sqrt(5.0)) / 2
INV_PHI = 1 / PHI

DITHERING_LIST_LEN = 256

# 8x8 Bayer ordered-dither matrix (main.pas:49-58)
DITHERING_MAP = np.array([
     0, 48, 12, 60,  3, 51, 15, 63,
    32, 16, 44, 28, 35, 19, 47, 31,
     8, 56,  4, 52, 11, 59,  7, 55,
    40, 24, 36, 20, 43, 27, 39, 23,
     2, 50, 14, 62,  1, 49, 13, 61,
    34, 18, 46, 30, 33, 17, 45, 29,
    10, 58,  6, 54,  9, 57,  5, 53,
    42, 26, 38, 22, 41, 25, 37, 21,
], dtype=np.int32)
DITHERING_LEN = DITHERING_MAP.size  # 64

# --- JPEG-style psychovisual DCT quantization tables (main.pas:63-98) ---
_CQ = np.sqrt(16.0)
_LUMA_Q = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float64)
_CHROMA_Q = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 112],
    [24, 26, 56, 99, 99, 99, 112, 128],
    [47, 66, 99, 99, 99, 112, 128, 144],
    [99, 99, 99, 99, 112, 128, 144, 160],
    [99, 99, 99, 112, 128, 144, 160, 176],
    [99, 99, 112, 128, 144, 160, 176, 192],
    [99, 112, 128, 144, 160, 176, 192, 208],
], dtype=np.float64)
# DCT_QUANT[cpn, v, u] multiplies coefficient (v,u) of plane cpn.
DCT_QUANT = np.stack([
    _CQ / np.sqrt(_LUMA_Q),
    _CQ / np.sqrt(_CHROMA_Q),
    _CQ / np.sqrt(_CHROMA_Q),
]).astype(np.float32)

# cUVRatio (main.pas:3000-3009): DC row/col damping applied per (v,u) cell.
_ratio_1d = np.full(TILE_W, 1.0)
_ratio_1d[0] = np.sqrt(0.5)
UV_RATIO = np.outer(_ratio_1d, _ratio_1d).astype(np.float32)  # [v,u]

# --- 8x8 DCT basis (main.pas:613-623) ---
# gDCTLut[v,u,y,x] = cos((x+0.5) u pi/16) cos((y+0.5) v pi/16)
_x = np.arange(TILE_W)
_u = np.arange(TILE_W)
_c = np.cos((_x[None, :] + 0.5) * _u[:, None] * np.pi / 16.0)  # [u, x]
DCT_BASIS_1D = _c.astype(np.float64)  # [freq, pos]
# Flattened 2-D basis matrix [64 pix, 64 coeff] for a single matmul:
# coeff[v*8+u] = sum_{y,x} pix[y,x] * B1[v,y] * B1[u,x]
DCT_BASIS_2D = np.einsum('vy,ux->yxvu', DCT_BASIS_1D, DCT_BASIS_1D)
DCT_BASIS_FLAT = DCT_BASIS_2D.reshape(TILE_PIXELS, TILE_PIXELS).astype(np.float32)

# --- default gammas (main.pas:586, main.lfm seEncGamma/seVisGamma) ---
DEFAULT_ENCODER_GAMMA = 2.0
DEFAULT_VISUAL_GAMMA = 0.6

# --- encoder steps, for progress reporting (main.pas:15, :61) ---
ENCODER_STEPS = (
    'load', 'dither', 'make_unique', 'global_tiling',
    'frame_tiling', 'reindex', 'smooth', 'save',
)

# KModes feature vector: 64 palette indexes + 16 zone features (kmodes.pas:15)
KMODES_FEATURE_COUNT = 80
KMODES_ZONE_COUNT = TILE_PIXELS // 4  # 16
DISSIM_SUB_MATCHING_BITS = 11  # Hamming term weight 2^11 (kmodes.pas:16)

# Shot-transition / keyframe detection (main.pas:985-990)
SHOT_TRANS_MAX_TILES_PER_KF = 24 * 1920 * 1080 // (TILE_W * TILE_W)
SHOT_TRANS_GRACE_PERIOD = 24
SHOT_TRANS_AVG_FRAMES = 6
SHOT_TRANS_SOFT_THRES = 0.9
SHOT_TRANS_HARD_THRES = 0.5

MAX_TILEMAP_W = 1920 // TILE_W
MAX_TILEMAP_H = 1080 // TILE_W


def equal_quality_tile_count(tile_count: float) -> int:
    """Tile budget heuristic sqrt(n)*log2(1+n) (main.pas:722-725)."""
    if tile_count <= 0:
        return 0
    return int(round(np.sqrt(tile_count) * np.log2(1 + tile_count)))


def gamma_lut(gamma_value: float) -> np.ndarray:
    """256-entry gamma LUT: (i/255)^gamma (main.pas:599-606)."""
    return (np.arange(256) / 255.0) ** gamma_value


def palette_pattern(palette_count: int, tile_palette_size: int,
                    curvature: float = 2.0) -> np.ndarray:
    """gPalettePattern (main.pas:625-641): per-palette sampling positions used
    by the Value-at-Risk quantizer to pick palette entries along a curvature
    ramp; normalized so the last entry of the last palette is 1."""
    pat = np.zeros((palette_count, tile_palette_size))
    f = 0.0
    for i in range(tile_palette_size):
        fp = f
        f = float(i + 2) ** curvature
        for j in range(palette_count):
            pat[j, i] = ((j + 1) / palette_count) * max(palette_count, f - fp) + fp
    pat /= pat[palette_count - 1, tile_palette_size - 1]
    return pat
