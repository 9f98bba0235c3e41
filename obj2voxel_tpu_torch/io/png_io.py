"""Texture image loading (reference: voxelio png::decode via stb, io.cpp:448-456).

Decodes image files (PNG and other PIL-supported formats) into (H, W) uint32
ARGB arrays for the device texture pool.
"""

from __future__ import annotations

import io

import numpy as np


def _to_argb(arr: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 RGBA -> (H, W) uint32 ARGB."""
    a = arr[:, :, 3].astype(np.uint32)
    r = arr[:, :, 0].astype(np.uint32)
    g = arr[:, :, 1].astype(np.uint32)
    b = arr[:, :, 2].astype(np.uint32)
    return (a << 24) | (r << 16) | (g << 8) | b


def load_image(path: str) -> np.ndarray | None:
    """Load an image file -> (H, W) uint32 ARGB, or None on failure."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        return None
    try:
        with Image.open(path) as img:
            rgba = np.asarray(img.convert("RGBA"), dtype=np.uint8)
    except Exception:
        return None
    return _to_argb(rgba)


def load_image_bytes(data: bytes) -> np.ndarray | None:
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        return None
    try:
        with Image.open(io.BytesIO(data)) as img:
            rgba = np.asarray(img.convert("RGBA"), dtype=np.uint8)
    except Exception:
        return None
    return _to_argb(rgba)


def pixels_to_argb(pixels: np.ndarray, width: int, height: int, channels: int) -> np.ndarray:
    """Raw 8-bit pixel buffer -> (H, W) uint32 ARGB.

    channels == 3 means RGB; channels == 4 means ARGB byte order, matching
    obj2voxel_texture_load_pixels (reference obj2voxel.h:331-342).
    """
    arr = np.asarray(pixels, np.uint8).reshape(height, width, channels)
    if channels == 3:
        r, g, b = (arr[:, :, i].astype(np.uint32) for i in range(3))
        a = np.full((height, width), 255, np.uint32)
    elif channels == 4:
        a, r, g, b = (arr[:, :, i].astype(np.uint32) for i in range(4))
    else:
        raise ValueError("channels must be 3 or 4")
    return (a << 24) | (r << 16) | (g << 8) | b


def argb_to_pixels(argb: np.ndarray, channels: int) -> np.ndarray:
    """(H, W) uint32 ARGB -> raw 8-bit buffer (inverse of pixels_to_argb)."""
    h, w = argb.shape
    out = np.empty((h, w, channels), np.uint8)
    if channels == 4:
        out[:, :, 0] = (argb >> 24) & 0xFF
        out[:, :, 1] = (argb >> 16) & 0xFF
        out[:, :, 2] = (argb >> 8) & 0xFF
        out[:, :, 3] = argb & 0xFF
    elif channels == 3:
        out[:, :, 0] = (argb >> 16) & 0xFF
        out[:, :, 1] = (argb >> 8) & 0xFF
        out[:, :, 2] = argb & 0xFF
    else:
        raise ValueError("channels must be 3 or 4")
    return out
