"""Image file IO for the demos, OpenCV if present, else PIL (port of
``tpuimg.utils.io``).

The reference's demos read/write PNGs via cv::imread/imwrite
(e.g. Histogram/main.cpp:90,171-185). Compute never depends on this module;
it reads and writes NumPy arrays on the host.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    def imread_gray(path: str) -> np.ndarray:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(f"failed to read image: {path}")
        return img

    def imread_rgb(path: str) -> np.ndarray:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"failed to read image: {path}")
        return img[..., ::-1].copy()

    def imwrite(path: str, img: np.ndarray) -> None:
        img = np.asarray(img)
        if img.ndim == 3:
            img = img[..., ::-1]
        if not cv2.imwrite(path, img):
            raise IOError(f"failed to write image: {path}")

except ImportError:
    from PIL import Image

    def imread_gray(path: str) -> np.ndarray:
        return np.asarray(Image.open(path).convert("L"))

    def imread_rgb(path: str) -> np.ndarray:
        return np.asarray(Image.open(path).convert("RGB"))

    def imwrite(path: str, img: np.ndarray) -> None:
        Image.fromarray(np.asarray(img)).save(path)
