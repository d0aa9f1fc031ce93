"""MAE reconstruction visualisation (VIS_MASK.ENABLE): a numpy copy of
``vtm/vis/mae_vis.py``.

Functional parity target: slowfast/models/masked.py (_patchify:185-195,
_unpatchify:197-202, _mae_visualize:505-548): compose
[original | masked | reconstruction] clips from the decoder's pixel
predictions — reconstruction keeps the visible patches from the input
and fills the dropped ones with the prediction.

Host-side numpy; the model side stays static-shape (full-grid preds +
binary mask from vtm_torch/models/masked.py::MaskMViTMAE, as numpy).
"""

from __future__ import annotations

import numpy as np

from vtm_torch.models.masked import _patchify_pixels


def _unpatchify(tokens: np.ndarray, t: int, h: int, w: int, u: int, p: int,
                c: int = 3) -> np.ndarray:
    """[B, t*h*w, u*p*p*c] -> [B, T, H, W, C] (reference _unpatchify)."""
    b = tokens.shape[0]
    x = tokens.reshape(b, t, h, w, u, p, p, c)
    x = x.transpose(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, t * u, h * p, w * p, c)


def mae_visualize(frames, preds, mask, patch_t_stride: int, patch: int,
                  time_stride_loss: bool = True):
    """Compose the comparison triple.

    frames: [B, T, H, W, C] input video (normalised space);
    preds:   [B, N, u*p*p*C] full-grid decoder output;
    mask:    [B, N] binary (1 = dropped).
    Returns (original, masked, reconstruction), each
    [B, T', H, W, C] where T' is the loss-time subsampling.
    """
    frames = np.asarray(frames, np.float32)
    preds = np.asarray(preds, np.float32)
    mask = np.asarray(mask, np.float32)[..., None]
    if time_stride_loss:
        imgs = frames[:, ::patch_t_stride]
        u = 1
    else:
        imgs = frames
        u = patch_t_stride
    b, T, H, W, c = imgs.shape
    t, h, w = T // u, H // patch, W // patch
    tokens = np.asarray(_patchify_pixels(imgs, patch, u))
    recon_tokens = preds * mask + tokens * (1 - mask)
    masked_tokens = tokens * (1 - mask)
    return (
        imgs,
        _unpatchify(masked_tokens, t, h, w, u, patch, c),
        _unpatchify(recon_tokens, t, h, w, u, patch, c),
    )
