"""The attention grid of a caption (counterpart of
``tpu_captioner/infer/visualize.py``; reference caption.py:386-416
``visualize_att``).

Each word of the caption over the image, with its 7x7 attention map
upsampled 24x.  The reference upsamples with skimage's
``pyramid_expand(upscale=24, sigma=8)``, which is a zoom followed by a
gaussian blur; skimage is not a dependency, so the map is zoomed with scipy
(linear, ``order=1``) and blurred with ``sigma`` 8.  The first frame
(``<start>``) shows the bare image (overlay alpha 0), the later ones an
overlay of alpha 0.8 in ``Greys_r``; 5 columns, at most 51 frames, all as
the reference.  scipy, matplotlib and PIL are imported inside the functions:
importing this module needs none of them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def upsample_alpha(alpha_2d: np.ndarray, upscale: int = 24, sigma: float = 8.0, smooth: bool = True) -> np.ndarray:
    """A (e, e) attention map as (e * upscale, e * upscale): ``pyramid_expand``'s
    zoom, then, with ``smooth``, its blur."""
    from scipy import ndimage

    up = ndimage.zoom(alpha_2d, upscale, order=1)
    if smooth:
        up = ndimage.gaussian_filter(up, sigma=sigma)
    return up


def visualize_att(
    image,  # a path, or an (H, W, 3) uint8 array
    seq: Sequence[int],
    alphas: np.ndarray,  # (len(seq), P)
    rev_word_map: Dict[int, str],
    smooth: bool = True,
    enc_image_size: int = 7,
    out_path: Optional[str] = None,
    show: bool = False,
) -> List[str]:
    """Draw the grid of ``seq``'s words over ``image`` with their maps; save
    it to ``out_path`` (matplotlib's ``Agg``, no display) or show it.
    Returns the caption's words."""
    import matplotlib

    if out_path is not None and not show:
        matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt
    from PIL import Image

    img = Image.open(image) if isinstance(image, (str, bytes)) else Image.fromarray(np.asarray(image))
    side = enc_image_size * 24
    img = img.resize([side, side], Image.Resampling.LANCZOS)

    words = [rev_word_map[int(i)] for i in seq]
    num_cols = 5
    num_rows = int(np.ceil(len(words) / num_cols))
    print("Caption:", " ".join(words))

    plt.figure(figsize=(num_cols * 2.2, num_rows * 2.4))
    for t, word in enumerate(words):
        if t > 50:
            break
        plt.subplot(num_rows, num_cols, t + 1)
        plt.text(0, 1.09, word, color="black", backgroundcolor="white", fontsize=12, va="bottom",
                 transform=plt.gca().transAxes)
        plt.imshow(img)
        cur = np.asarray(alphas[t]).reshape(enc_image_size, enc_image_size)
        plt.imshow(upsample_alpha(cur, 24, 8.0, smooth), alpha=0.0 if t == 0 else 0.8)
        plt.set_cmap(cm.Greys_r)
        plt.axis("off")
    plt.subplots_adjust(hspace=0.05)
    if out_path is not None:
        plt.savefig(out_path, bbox_inches="tight")
        plt.close()
    elif show:
        plt.show()
    return words
