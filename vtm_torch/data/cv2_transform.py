"""Per-image-list cv2/numpy transforms (copy of
``vtm/data/cv2_transform.py``: the AVA and demo preprocessing surface;
cv2 is imported where a function resizes or flips).

Functional parity target: slowfast/datasets/cv2_transform.py:9-797 —
the full public API: short-side scaling (+boxes), flips (+boxes),
left/center/right and random crops (+boxes), padding, layout
transposes, ResNet-style scale jitter, Inception-style random sized
crop, AlexNet PCA lighting, per-channel normalisation, and the CHW
colour ops (grayscale / saturation / brightness / contrast / jitter).

Random-draw ORDER matches the reference exactly (same np.random calls
in the same sequence), so seeded runs are bit-comparable. Batched
variants of the box-aware subset live in vtm_torch/data/transform.py;
this module keeps the reference's list-of-images signatures.
"""

from __future__ import annotations

import math

import numpy as np


# --------------------------------------------------------------- boxes


def clip_boxes_to_image(boxes, height, width):
    """Clamp x to [0, width-1], y to [0, height-1] (reference :9-26)."""
    boxes = boxes.copy()
    boxes[:, [0, 2]] = np.minimum(
        width - 1.0, np.maximum(0.0, boxes[:, [0, 2]])
    )
    boxes[:, [1, 3]] = np.minimum(
        height - 1.0, np.maximum(0.0, boxes[:, [1, 3]])
    )
    return boxes


def flip_boxes(boxes, im_width):
    """Mirror x coordinates (reference :365-378)."""
    out = boxes.copy()
    out[:, 0::4] = im_width - boxes[:, 2::4] - 1
    out[:, 2::4] = im_width - boxes[:, 0::4] - 1
    return out


def crop_boxes(boxes, x_offset, y_offset):
    """Shift boxes by the crop offsets, in place (reference :381-391)."""
    boxes[:, [0, 2]] = boxes[:, [0, 2]] - x_offset
    boxes[:, [1, 3]] = boxes[:, [1, 3]] - y_offset
    return boxes


def scale_boxes(size, boxes, height, width):
    """Scale boxes by the short-side-to-``size`` ratio, in place
    (reference :106-131)."""
    short, long = (width, height) if width <= height else (height, width)
    if short == size:
        return boxes
    new_long = int(math.floor(float(long) / short * size))
    boxes *= float(new_long) / long
    return boxes


def revert_scaled_boxes(size, boxes, img_height, img_width):
    """Undo a short-side scale to ``size`` (reference :783-797)."""
    return boxes * (np.min([img_height, img_width]) / size)


# ------------------------------------------------------------- geometry


def _short_side_dims(height, width, size):
    """(new_h, new_w) for a short-side scale, or None when a no-op
    (the reference's early-return condition)."""
    if (width <= height and width == size) or (
        height <= width and height == size
    ):
        return None
    if width < height:
        return int(math.floor(float(height) / width * size)), size
    return size, int(math.floor(float(width) / height * size))


def scale(size, image):
    """Short-side scale one HWC image (reference :77-103)."""
    import cv2

    dims = _short_side_dims(image.shape[0], image.shape[1], size)
    if dims is None:
        return image
    new_h, new_w = dims
    return cv2.resize(
        image, (new_w, new_h), interpolation=cv2.INTER_LINEAR
    ).astype(np.float32)


def random_short_side_scale_jitter_list(images, min_size, max_size,
                                        boxes=None):
    """Inverse-uniform short-side jitter over a clip (reference :29-74).
    One scale is drawn for the whole list; boxes scale with it."""
    import cv2

    size = int(round(1.0 / np.random.uniform(1.0 / max_size, 1.0 / min_size)))
    dims = _short_side_dims(images[0].shape[0], images[0].shape[1], size)
    if dims is None:
        return images, boxes
    new_h, new_w = dims
    if boxes is not None:
        long_in = max(images[0].shape[0], images[0].shape[1])
        long_out = max(new_h, new_w)
        boxes = [b * float(long_out) / long_in for b in boxes]
    return (
        [
            cv2.resize(
                im, (new_w, new_h), interpolation=cv2.INTER_LINEAR
            ).astype(np.float32)
            for im in images
        ],
        boxes,
    )


def random_scale_jitter(image, min_size, max_size):
    """ResNet-style scale jitter, single image (reference :477-492)."""
    size = int(round(1.0 / np.random.uniform(1.0 / max_size, 1.0 / min_size)))
    return scale(size, image)


def random_scale_jitter_list(images, min_size, max_size):
    """Shared-scale jitter over a list (reference :495-510)."""
    size = int(round(1.0 / np.random.uniform(1.0 / max_size, 1.0 / min_size)))
    return [scale(size, image) for image in images]


def horizontal_flip(prob, image, order="CHW"):
    """Flip one image with probability ``prob`` (reference :344-362)."""
    assert order in ("CHW", "HWC"), f"order {order} is not supported"
    if np.random.uniform() < prob:
        image = image[:, :, ::-1] if order == "CHW" else image[:, ::-1, :]
    return image


def horizontal_flip_list(prob, images, order="CHW", boxes=None):
    """Flip a clip (+boxes) with one shared draw (reference :134-163)."""
    import cv2

    _, width, _ = images[0].shape
    if np.random.uniform() < prob:
        if boxes is not None:
            boxes = [flip_boxes(b, width) for b in boxes]
        if order == "CHW":
            # quirk kept: the reference flips axis 0 of the (2,0)-swap,
            # i.e. the WIDTH axis of a CHW-shaped input read as HWC
            return (
                [
                    np.asarray(im).swapaxes(2, 0)[::-1].swapaxes(0, 2)
                    for im in images
                ],
                boxes,
            )
        if order == "HWC":
            return [cv2.flip(im, 1) for im in images], boxes
    return images, boxes


def spatial_shift_crop_list(size, images, spatial_shift_pos, boxes=None):
    """Left/center/right (or top/center/bottom) crop (reference
    :166-214)."""
    assert spatial_shift_pos in (0, 1, 2)
    height, width = images[0].shape[0], images[0].shape[1]
    y_offset = int(math.ceil((height - size) / 2))
    x_offset = int(math.ceil((width - size) / 2))
    if height > width:
        if spatial_shift_pos == 0:
            y_offset = 0
        elif spatial_shift_pos == 2:
            y_offset = height - size
    else:
        if spatial_shift_pos == 0:
            x_offset = 0
        elif spatial_shift_pos == 2:
            x_offset = width - size
    cropped = [
        im[y_offset : y_offset + size, x_offset : x_offset + size, :]
        for im in images
    ]
    assert cropped[0].shape[0] == size and cropped[0].shape[1] == size
    if boxes is not None:
        for b in boxes:
            b[:, [0, 2]] -= x_offset
            b[:, [1, 3]] -= y_offset
    return cropped, boxes


def pad_image(image, pad_size, order="CHW"):
    """Constant-pad H and W (reference :319-341)."""
    spec = (
        ((0, 0), (pad_size, pad_size), (pad_size, pad_size))
        if order == "CHW"
        else ((pad_size, pad_size), (pad_size, pad_size), (0, 0))
    )
    return np.pad(image, spec, mode="constant")


def random_crop_list(images, size, pad_size=0, order="CHW", boxes=None):
    """Shared random crop over a clip (reference :394-455)."""
    if pad_size > 0:
        images = [
            pad_image(image=im, pad_size=pad_size, order=order)
            for im in images
        ]
    h_ax, w_ax = (1, 2) if order == "CHW" else (0, 1)
    height, width = images[0].shape[h_ax], images[0].shape[w_ax]
    if height == size and width == size:
        return images, boxes
    y_offset = int(np.random.randint(0, height - size)) if height > size else 0
    x_offset = int(np.random.randint(0, width - size)) if width > size else 0
    if order == "CHW":
        cropped = [
            im[:, y_offset : y_offset + size, x_offset : x_offset + size]
            for im in images
        ]
    else:
        cropped = [
            im[y_offset : y_offset + size, x_offset : x_offset + size, :]
            for im in images
        ]
    assert cropped[0].shape[h_ax] == size and cropped[0].shape[w_ax] == size
    if boxes is not None:
        boxes = [crop_boxes(b, x_offset, y_offset) for b in boxes]
    return cropped, boxes


def center_crop(size, image):
    """Center crop one HWC image (reference :458-473)."""
    height, width = image.shape[0], image.shape[1]
    y_offset = int(math.ceil((height - size) / 2))
    x_offset = int(math.ceil((width - size) / 2))
    out = image[y_offset : y_offset + size, x_offset : x_offset + size, :]
    assert out.shape[0] == size and out.shape[1] == size
    return out


def _random_sized_window(height, width, area_frac):
    """One Inception-crop proposal draw (shared by the single/list
    variants; same draw order as the reference loop body)."""
    area = height * width
    target_area = np.random.uniform(area_frac, 1.0) * area
    aspect = np.random.uniform(3.0 / 4.0, 4.0 / 3.0)
    w = int(round(math.sqrt(float(target_area) * aspect)))
    h = int(round(math.sqrt(float(target_area) / aspect)))
    if np.random.uniform() < 0.5:
        w, h = h, w
    if h > height or w > width:
        return None
    y = 0 if height == h else int(np.random.randint(0, height - h))
    x = 0 if width == w else int(np.random.randint(0, width - w))
    return y, x, h, w


def random_sized_crop(image, size, area_frac=0.08):
    """Inception-style random sized crop (reference :513-553)."""
    import cv2

    for _ in range(10):
        win = _random_sized_window(image.shape[0], image.shape[1], area_frac)
        if win is None:
            continue
        y, x, h, w = win
        out = image[y : y + h, x : x + w, :]
        return cv2.resize(
            out, (size, size), interpolation=cv2.INTER_LINEAR
        ).astype(np.float32)
    return center_crop(size, scale(size, image))


def random_sized_crop_list(images, size, crop_area_fraction=0.08):
    """Shared Inception crop over a clip (reference :582-629)."""
    import cv2

    for _ in range(10):
        win = _random_sized_window(
            images[0].shape[0], images[0].shape[1], crop_area_fraction
        )
        if win is None:
            continue
        y, x, h, w = win
        return [
            cv2.resize(
                im[y : y + h, x : x + w, :], (size, size),
                interpolation=cv2.INTER_LINEAR,
            ).astype(np.float32)
            for im in images
        ]
    return [center_crop(size, scale(size, image)) for image in images]


# --------------------------------------------------------------- layout


def CHW2HWC(image):
    return image.transpose([1, 2, 0])


def HWC2CHW(image):
    return image.transpose([2, 0, 1])


# --------------------------------------------------------------- colour
# These operate on CHW images with BGR channel order (cv2 decode), so
# the grayscale weights index [2]=R, [1]=G, [0]=B — reference :636-652.


def blend(image1, image2, alpha):
    return image1 * alpha + image2 * (1 - alpha)


def grayscale(image):
    gray = 0.299 * image[2] + 0.587 * image[1] + 0.114 * image[0]
    return np.broadcast_to(gray.astype(image.dtype), image.shape).copy()


def saturation(var, image):
    img_gray = grayscale(image)
    alpha = 1.0 + np.random.uniform(-var, var)
    return blend(image, img_gray, alpha)


def brightness(var, image):
    alpha = 1.0 + np.random.uniform(-var, var)
    return blend(image, np.zeros_like(image), alpha)


def contrast(var, image):
    img_gray = np.full_like(image, np.mean(grayscale(image)[0]))
    alpha = 1.0 + np.random.uniform(-var, var)
    return blend(image, img_gray, alpha)


def saturation_list(var, images):
    alpha = 1.0 + np.random.uniform(-var, var)
    return [blend(im, grayscale(im), alpha) for im in images]


def brightness_list(var, images):
    alpha = 1.0 + np.random.uniform(-var, var)
    return [blend(im, np.zeros_like(im), alpha) for im in images]


def contrast_list(var, images):
    alpha = 1.0 + np.random.uniform(-var, var)
    return [
        blend(im, np.full_like(im, np.mean(grayscale(im)[0])), alpha)
        for im in images
    ]


def _jitter_order(img_brightness, img_contrast, img_saturation):
    ops = []
    if img_brightness != 0:
        ops.append("brightness")
    if img_contrast != 0:
        ops.append("contrast")
    if img_saturation != 0:
        ops.append("saturation")
    if not ops:
        return []
    perm = np.random.permutation(np.arange(len(ops)))
    return [ops[i] for i in perm]


def color_jitter(image, img_brightness=0, img_contrast=0, img_saturation=0):
    """Randomly-ordered brightness/contrast/saturation (reference
    :752-780)."""
    for op in _jitter_order(img_brightness, img_contrast, img_saturation):
        image = {
            "brightness": lambda: brightness(img_brightness, image),
            "contrast": lambda: contrast(img_contrast, image),
            "saturation": lambda: saturation(img_saturation, image),
        }[op]()
    return image


def color_jitter_list(images, img_brightness=0, img_contrast=0,
                      img_saturation=0):
    """Clip variant with one shared alpha per op (reference :240-270)."""
    for op in _jitter_order(img_brightness, img_contrast, img_saturation):
        images = {
            "brightness": lambda: brightness_list(img_brightness, images),
            "contrast": lambda: contrast_list(img_contrast, images),
            "saturation": lambda: saturation_list(img_saturation, images),
        }[op]()
    return images


def lighting(img, alphastd, eigval, eigvec):
    """AlexNet PCA jitter, single CHW-BGR image (reference :556-579)."""
    if alphastd == 0:
        return img
    rgb = _lighting_rgb(alphastd, eigval, eigvec)
    for idx in range(img.shape[0]):
        img[idx] = img[idx] + rgb[2 - idx]
    return img


def lighting_list(imgs, alphastd, eigval, eigvec, alpha=None):
    """Clip variant with one shared alpha draw (reference :273-299)."""
    if alphastd == 0:
        return imgs
    rgb = _lighting_rgb(alphastd, eigval, eigvec)
    out = []
    for img in imgs:
        for idx in range(img.shape[0]):
            img[idx] = img[idx] + rgb[2 - idx]
        out.append(img)
    return out


def _lighting_rgb(alphastd, eigval, eigvec):
    alpha = np.random.normal(0, alphastd, size=(1, 3))
    eig_vec = np.array(eigvec)
    eig_val = np.reshape(eigval, (1, 3))
    return np.sum(
        eig_vec * np.repeat(alpha, 3, axis=0) * np.repeat(eig_val, 3, axis=0),
        axis=1,
    )


def color_normalization(image, mean, stddev):
    """Per-channel (x - mean) / std on a CHW image, in place
    (reference :302-316)."""
    assert len(mean) == image.shape[0]
    assert len(stddev) == image.shape[0]
    for idx in range(image.shape[0]):
        image[idx] = (image[idx] - mean[idx]) / stddev[idx]
    return image
