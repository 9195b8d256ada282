"""Host-side debug rendering with PIL: keypoint overlays, belief-map images,
mosaics.

Counterpart of the part of `sgtapose_tpu/utils/visualize.py` the per-frame
debugger uses (`_DEFAULT_COLORS`, `overlay_points_on_image`,
`image_from_belief_map`, `mosaic_images`), the same functions of the same
inputs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

_DEFAULT_COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
    (255, 0, 255), (0, 255, 255), (255, 128, 0), (128, 0, 255), (0, 128, 255),
]


def overlay_points_on_image(image: np.ndarray, points: Sequence[Sequence[float]],
                            annotations: Optional[Sequence[str]] = None, point_diameter: int = 8,
                            colors: Optional[Sequence[Tuple[int, int, int]]] = None):
    """image: (H, W, 3) uint8; points: [(x, y), ...], a sentinel (< -999)
    skipped. Returns a PIL Image."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    draw = ImageDraw.Draw(img)
    colors = colors or _DEFAULT_COLORS
    r = point_diameter / 2.0
    for i, pt in enumerate(points):
        x, y = float(pt[0]), float(pt[1])
        if x < -999.0 or y < -999.0:
            continue
        c = tuple(colors[i % len(colors)])
        draw.ellipse([x - r, y - r, x + r, y + r], fill=c, outline=(255, 255, 255))
        if annotations is not None and i < len(annotations):
            draw.text((x + r + 1, y - r), str(annotations[i]), fill=c)
    return img


def image_from_belief_map(belief_map: np.ndarray, normalization: str = "frame"):
    """(H, W) float map -> PIL image on a black-red-yellow-white ramp.
    normalization: 'frame' (min-max of this map) | 'none' (clip to [0, 1])."""
    from PIL import Image

    m = np.asarray(belief_map, np.float32)
    if normalization == "frame":
        lo, hi = float(m.min()), float(m.max())
        m = (m - lo) / (hi - lo) if hi > lo else np.zeros_like(m)
    else:
        m = np.clip(m, 0.0, 1.0)
    r = np.clip(m * 3.0, 0, 1)
    g = np.clip(m * 3.0 - 1.0, 0, 1)
    b = np.clip(m * 3.0 - 2.0, 0, 1)
    return Image.fromarray((np.stack([r, g, b], axis=-1) * 255).astype(np.uint8))


def mosaic_images(images: List, rows: int, cols: int, inner_padding_px: int = 2):
    """Grid mosaic of PIL images, each resized to the first one's size."""
    from PIL import Image

    assert images, "empty mosaic"
    w, h = images[0].size
    pad = inner_padding_px
    canvas = Image.new("RGB", (cols * w + (cols - 1) * pad, rows * h + (rows - 1) * pad), (30, 30, 30))
    for idx, im in enumerate(images[: rows * cols]):
        rr, cc = idx // cols, idx % cols
        canvas.paste(im.resize((w, h)), (cc * (w + pad), rr * (h + pad)))
    return canvas
