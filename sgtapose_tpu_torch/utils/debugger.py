"""Per-frame visual debugger, on the host with numpy and PIL.

Counterpart of `sgtapose_tpu/utils/debugger.py:Debugger`, the same images
from the same inputs:
  * a registry of named images (`add_img`, `imgs`, `clear`);
  * class-coloured heatmap colormaps (`gen_colormap`, `gen_colormap_hp`),
    max-composited over classes;
  * alpha blends of a colormap over an image (`add_blend_img`, `add_mask`);
  * annotations: keypoint dots (`add_keypoints`), tracking-offset arrows
    (`add_arrow`), track ids (`add_tracking_id`);
  * output (`save_img`, `save_all_imgs`; `show_all_imgs` saves, there being
    no display).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from sgtapose_tpu_torch.utils.visualize import _DEFAULT_COLORS, overlay_points_on_image


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


class Debugger:
    """Named debug images of one frame."""

    def __init__(self, num_classes: int = 7, colors: Optional[Sequence[Tuple[int, int, int]]] = None):
        self.imgs: Dict[str, np.ndarray] = {}
        self.num_classes = num_classes
        base = list(colors or _DEFAULT_COLORS)
        while len(base) < num_classes:  # a deterministic extension of the palette
            i = len(base)
            base.append(tuple(int(v) % 256 for v in (37 * i + 89, 91 * i + 43, 53 * i + 157)))
        self.colors = np.asarray(base, np.uint8)

    # ---- registry ------------------------------------------------------------

    def clear(self) -> None:
        self.imgs = {}

    def add_img(self, img: np.ndarray, img_id: str = "default", revert_color: bool = False) -> None:
        img = _to_uint8(img)
        if revert_color:
            img = (255 - img.astype(np.int16)).astype(np.uint8)
        self.imgs[img_id] = img.copy()

    # ---- colormaps -----------------------------------------------------------

    def _colormap(self, hm: np.ndarray, palette: np.ndarray,
                  output_res: Optional[Tuple[int, int]] = None, channel_first: bool = False) -> np.ndarray:
        """(H, W, C) float heatmap (or (C, H, W) with channel_first) ->
        (H_out, W_out, 3) uint8: each class's colour scaled by its intensity,
        the maximum over classes; output_res (w, h) resizes bilinearly."""
        hm = np.asarray(hm, np.float32)
        if hm.ndim == 2:
            hm = hm[..., None]
        if channel_first:
            hm = np.moveaxis(hm, 0, -1)
        hm = np.clip(hm, 0.0, 1.0)
        C = hm.shape[-1]
        pal = palette[np.arange(C) % len(palette)].astype(np.float32)  # (C, 3)
        out = (hm[..., None] * pal[None, None]).max(axis=2)
        out = np.clip(out, 0, 255).astype(np.uint8)
        if output_res is not None:
            from PIL import Image

            w, h = int(output_res[0]), int(output_res[1])
            out = np.asarray(Image.fromarray(out).resize((w, h), Image.BILINEAR))
        return out

    def gen_colormap(self, hm: np.ndarray, output_res: Optional[Tuple[int, int]] = None,
                     channel_first: bool = False) -> np.ndarray:
        """Centre-heatmap colormap."""
        return self._colormap(hm, self.colors, output_res, channel_first)

    def gen_colormap_hp(self, hm: np.ndarray, output_res: Optional[Tuple[int, int]] = None,
                        channel_first: bool = False) -> np.ndarray:
        """Keypoint-heatmap colormap: the palette rolled by 3 classes."""
        return self._colormap(hm, np.roll(self.colors, 3, axis=0), output_res, channel_first)

    # ---- composites ----------------------------------------------------------

    def add_blend_img(self, back: np.ndarray, fore: np.ndarray, img_id: str = "blend",
                      trans: float = 0.7) -> None:
        """back*trans + fore*(1-trans), fore resized to back."""
        back = _to_uint8(back).astype(np.float32)
        fore = _to_uint8(fore)
        if fore.shape[:2] != back.shape[:2]:
            from PIL import Image

            fore = np.asarray(Image.fromarray(fore).resize((back.shape[1], back.shape[0]), Image.BILINEAR))
        if fore.ndim == 2:
            fore = np.repeat(fore[..., None], 3, axis=-1)
        out = back * trans + fore.astype(np.float32) * (1.0 - trans)
        self.imgs[img_id] = np.clip(out, 0, 255).astype(np.uint8)

    def add_mask(self, mask: np.ndarray, bg: np.ndarray, img_id: str = "default", trans: float = 0.8) -> None:
        """A binary mask highlighted over a background."""
        m = (np.asarray(mask) > 0).astype(np.float32)[..., None]
        bg = _to_uint8(bg).astype(np.float32)
        hi = np.array([255.0, 255.0, 255.0])
        out = bg * (1 - m) + (bg * trans + hi * (1 - trans)) * m
        self.imgs[img_id] = np.clip(out, 0, 255).astype(np.uint8)

    # ---- annotations ---------------------------------------------------------

    def _draw(self, img_id: str):
        from PIL import Image, ImageDraw

        if img_id not in self.imgs:
            raise KeyError(f"no image {img_id!r}; call add_img first")
        pil = Image.fromarray(self.imgs[img_id])
        return pil, ImageDraw.Draw(pil)

    def add_keypoints(self, points: np.ndarray, img_id: str = "default", radius: int = 4,
                      scores: Optional[np.ndarray] = None) -> None:
        """Class-coloured keypoint dots, sentinel rows skipped, each with its
        score where scores are given."""
        if img_id not in self.imgs:
            raise KeyError(f"no image {img_id!r}; call add_img first")
        ann = None if scores is None else [f"{float(s):.2f}" for s in scores]
        pil = overlay_points_on_image(self.imgs[img_id], np.asarray(points, np.float32), annotations=ann,
                                      point_diameter=2 * radius,
                                      colors=[tuple(int(v) for v in c) for c in self.colors])
        self.imgs[img_id] = np.asarray(pil)

    def add_arrow(self, st: Sequence[float], ed: Sequence[float], img_id: str = "default",
                  c: Tuple[int, int, int] = (255, 0, 255), w: int = 2) -> None:
        """Tracking-offset arrow from st to st + ed (ed the displacement)."""
        pil, draw = self._draw(img_id)
        x0, y0 = float(st[0]), float(st[1])
        x1, y1 = x0 + float(ed[0]), y0 + float(ed[1])
        draw.line([x0, y0, x1, y1], fill=c, width=w)
        # the head: two short back-strokes
        v = np.array([x1 - x0, y1 - y0], np.float32)
        n = float(np.hypot(*v))
        if n > 1e-3:
            v = v / n * min(6.0, n)
            for rot in (0.5, -0.5):
                ca, sa = np.cos(rot), np.sin(rot)
                hx = x1 - (ca * v[0] - sa * v[1])
                hy = y1 - (sa * v[0] + ca * v[1])
                draw.line([x1, y1, hx, hy], fill=c, width=w)
        self.imgs[img_id] = np.asarray(pil)

    def add_tracking_id(self, ct: Sequence[float], tracking_id, img_id: str = "default",
                        c: Tuple[int, int, int] = (255, 255, 255)) -> None:
        """A track id written at a centre point."""
        pil, draw = self._draw(img_id)
        draw.text((float(ct[0]), float(ct[1]) - 10), str(tracking_id), fill=c)
        self.imgs[img_id] = np.asarray(pil)

    # ---- output --------------------------------------------------------------

    def save_img(self, img_id: str = "default", path: str = "./debug") -> str:
        from PIL import Image

        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, f"{img_id}.png")
        Image.fromarray(self.imgs[img_id]).save(out)
        return out

    def save_all_imgs(self, path: str = "./debug", prefix: str = "") -> None:
        """Write every registered image as {path}/{prefix}{id}.png."""
        from PIL import Image

        os.makedirs(path, exist_ok=True)
        for img_id, img in self.imgs.items():
            Image.fromarray(img).save(os.path.join(path, f"{prefix}{img_id}.png"))

    def show_all_imgs(self, path: str = "./debug", prefix: str = "") -> None:
        """No display: saves, as `save_all_imgs`."""
        self.save_all_imgs(path, prefix=prefix)
