"""Image preprocessing for training pipelines (v2 API surface).

A copy of paddle_tpu/v2/image.py (reference: python/paddle/v2/image.py
— load/resize/crop/flip/transform helpers over cv2 ndarrays).  Same
function surface and HWC-uint8 conventions; the implementation here is PIL for codec work
and numpy for the geometry, so the hot path (feeding the card's input
pipeline from a reader) has no OpenCV dependency.  All transforms are
host-side numpy by design — on this stack augmentation belongs in the
reader/prefetch pipeline (reader/prefetch.py overlaps it with device
steps), not in the program.
"""

import io
import tarfile

import numpy as np

__all__ = [
    "batch_images_from_tar", "load_image_bytes", "load_image",
    "resize_short", "to_chw", "center_crop", "random_crop",
    "left_right_flip", "simple_transform", "load_and_transform",
]


def _decode(raw, is_color):
    from PIL import Image

    im = Image.open(io.BytesIO(raw))
    im = im.convert("RGB" if is_color else "L")
    return np.asarray(im)


def load_image_bytes(bytes, is_color=True):
    """Decode an encoded image buffer to an HWC uint8 ndarray (HW when
    ``is_color`` is false)."""
    return _decode(bytes, is_color)


def load_image(file, is_color=True):
    """Decode an image file path to an HWC/HW uint8 ndarray."""
    with open(file, "rb") as f:
        return _decode(f.read(), is_color)


def resize_short(im, size):
    """Scale so the SHORTER edge becomes ``size``, preserving aspect
    ratio (the standard ImageNet eval prelude to a center crop)."""
    from PIL import Image

    h, w = im.shape[:2]
    if h <= w:
        new_h, new_w = size, max(1, int(round(w * size / float(h))))
    else:
        new_h, new_w = max(1, int(round(h * size / float(w)))), size
    mode = Image.fromarray(im)
    return np.asarray(mode.resize((new_w, new_h), Image.BILINEAR))


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (the layout the NCHW image models feed on; pair with
    fluid.convert_layout for NHWC execution instead of re-ordering
    here twice)."""
    return im.transpose(order)


def _crop(im, size, h0, w0):
    return im[h0:h0 + size, w0:w0 + size]


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    return _crop(im, size, (h - size) // 2, (w - size) // 2)


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = np.random.randint(0, h - size + 1)
    w0 = np.random.randint(0, w - size + 1)
    return _crop(im, size, h0, w0)


def left_right_flip(im, is_color=True):
    """Horizontal mirror (axis 1 is width for both HWC and HW)."""
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None):
    """The standard train/eval transform: resize-short, then random
    crop + coin-flip mirror (train) or center crop (eval), CHW float32,
    optional mean subtraction (scalar per channel or full ndarray)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2):
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]   # per-channel over CHW
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pre-batch a tar of encoded images into .npz shards + a meta
    file, returning the meta path.  The reference emits pickled
    cPickle batches (image.py:48-108); shards here are npz (arrays of
    encoded bytes + labels) so the reader side stays numpy-only.
    Entries missing from ``img2label`` are skipped, like the
    reference's membership check."""
    import os

    def ragged(rows):
        # an explicit object array: np.asarray would silently build a
        # 2-D table when the encoded buffers happen to share a length,
        # and its rows don't round-trip through tobytes()
        arr = np.empty(len(rows), dtype=object)
        for i, r in enumerate(rows):
            arr[i] = r
        return arr

    out_path = data_file + "_%s_batch" % dataset_name
    os.makedirs(out_path, exist_ok=True)
    data, labels, meta, n = [], [], [], 0
    with tarfile.open(data_file) as tf:
        for mem in tf.getmembers():
            if not mem.isfile() or mem.name not in img2label:
                continue
            data.append(np.frombuffer(tf.extractfile(mem).read(),
                                      np.uint8))
            labels.append(int(img2label[mem.name]))
            if len(data) == num_per_batch:
                fname = os.path.join(out_path, "batch_%05d.npz" % n)
                np.savez(fname, data=ragged(data),
                         labels=np.asarray(labels, np.int64))
                meta.append(fname)
                data, labels = [], []
                n += 1
        if data:
            fname = os.path.join(out_path, "batch_%05d.npz" % n)
            np.savez(fname, data=ragged(data),
                     labels=np.asarray(labels, np.int64))
            meta.append(fname)
    meta_file = os.path.join(out_path, "batches.meta")
    with open(meta_file, "w") as f:
        f.write("\n".join(meta))
    return meta_file
