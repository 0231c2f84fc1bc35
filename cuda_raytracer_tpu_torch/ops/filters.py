"""Film reconstruction, accumulation and post-process filters (torch).

The port of ``cuda_raytracer_tpu/ops/filters.py`` (kernelReconstructImage
/ kernelAccumulate / kernelMedianFilter of the reference).

On the card the film is two kernels of ``ops/csrc/film.cu``:
``film_kernel`` (reconstruct, with or without the accumulate: ``film``
is both in one launch, ``reconstruct`` and ``accumulate`` each alone)
and ``median3x3_kernel``.  On CUDA tensors these functions launch them
or raise; on CPU tensors they run their plain versions (``*_plain``);
any other device is refused.  ``film_launches`` and ``median_launches``
count the launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: launches of film_kernel and median3x3_kernel (ops/csrc/film.cu) since
#: the count was last set to 0
film_launches = 0
median_launches = 0


def _path(x: torch.Tensor) -> str:
    """The film's path for tensors on x's device: "cuda" or "cpu"."""
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no film path for device {x.device}")
    return kind


def reconstruct(sample_light: torch.Tensor, width: int, height: int,
                spp: int, inv_order=None, sample_major: bool = False):
    """Box-filter the per-sample radiance [W*H*spp, 3] into an image
    [H, W, 3].  Pixel-major by default; ``sample_major`` for the
    tiles32s layout; ``inv_order`` ([H*W], inv_order[pixel] = slot)
    un-swizzles a tiled sample order."""
    args = (sample_light, width, height, spp, inv_order, sample_major)
    if _path(sample_light) == "cuda":
        return reconstruct_cuda(*args)
    return reconstruct_plain(*args)


def reconstruct_plain(sample_light: torch.Tensor, width: int, height: int,
                      spp: int, inv_order=None, sample_major: bool = False):
    """``reconstruct`` in torch ops (any device)."""
    if sample_major:
        means = sample_light.reshape(spp, -1, 3).mean(dim=0)
    else:
        means = sample_light.reshape(-1, spp, 3).mean(dim=1)
    if inv_order is not None:
        means = means[inv_order]
    return means.reshape(height, width, 3)


def accumulate(final_img, new_img, old_weight, new_weight):
    """Running average across frames.  ``old_weight`` is a float or a
    0-d float32 tensor on the images' device (a captured frame's sample
    count, which the engine rewrites before each replay); the two give
    the same bits."""
    args = (final_img, new_img, old_weight, new_weight)
    if _path(new_img) == "cuda":
        return accumulate_cuda(*args)
    return accumulate_plain(*args)


def film(sample_light: torch.Tensor, final_img, old_weight, new_weight,
         width: int, height: int, spp: int, inv_order=None,
         sample_major: bool = False):
    """``accumulate(final_img, reconstruct(sample_light, ...), old_weight,
    new_weight)``: the frame's film, one launch on the card."""
    args = (sample_light, final_img, old_weight, new_weight, width, height,
            spp, inv_order, sample_major)
    if _path(sample_light) == "cuda":
        return film_cuda(*args)
    return film_plain(*args)


def film_plain(sample_light: torch.Tensor, final_img, old_weight,
               new_weight, width: int, height: int, spp: int,
               inv_order=None, sample_major: bool = False):
    """``film`` in torch ops (any device)."""
    img = reconstruct_plain(sample_light, width, height, spp, inv_order,
                            sample_major)
    return accumulate_plain(final_img, img, old_weight, new_weight)


def accumulate_plain(final_img, new_img, old_weight, new_weight):
    """``accumulate`` in torch ops (any device).  On the card torch
    divides by a host float as a product with its float32 reciprocal, so
    the tensor form does the same there."""
    num = final_img * old_weight + new_img * new_weight
    den = old_weight + new_weight
    if isinstance(den, torch.Tensor) and den.device.type == "cuda":
        return num * torch.reciprocal(den)
    return num / den


def median_filter_3x3(img: torch.Tensor, reference_compat: bool = False):
    """Per-channel 3x3 median.  ``reference_compat`` pads with white and
    takes the reference's "4th largest" (index 5 ascending); the default
    clamps to the edge and takes the true median (index 4)."""
    if _path(img) == "cuda":
        return median_filter_3x3_cuda(img, reference_compat)
    return median_filter_3x3_plain(img, reference_compat)


def median_filter_3x3_plain(img: torch.Tensor,
                            reference_compat: bool = False):
    """``median_filter_3x3`` in torch ops (any device)."""
    h, w, _ = img.shape
    chw = img.permute(2, 0, 1)[None]
    if reference_compat:
        pad = F.pad(chw, (1, 1, 1, 1), mode="constant", value=1.0)
    else:
        pad = F.pad(chw, (1, 1, 1, 1), mode="replicate")
    pad = pad[0].permute(1, 2, 0)  # [H+2, W+2, 3]
    views = torch.stack(
        [pad[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
        dim=2,
    )
    idx = 5 if reference_compat else 4
    return torch.sort(views, dim=2).values[:, :, idx, :]


# ---------------------------------------------------------------------------
# the kernels' wrappers (ops/csrc/film.cu)
# ---------------------------------------------------------------------------

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float


class _FilmArgs(ctypes.Structure):
    _fields_ = [
        ("n_pix", _L), ("spp", _L), ("samples", _P), ("inv_order", _P),
        ("final_in", _P), ("old_ptr", _P), ("out", _P),
        ("sample_major", _I), ("accumulate", _I), ("old_weight", _F),
        ("new_weight", _F),
    ]


class _MedianArgs(ctypes.Structure):
    _fields_ = [("img", _P), ("out", _P), ("h", _I), ("w", _I),
                ("compat", _I)]


_ARGS = {"film": _FilmArgs, "median3x3": _MedianArgs}
_lib = None


def _load_library():
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library("film")
        lib.film_args_size.argtypes = [ctypes.c_int]
        lib.film_args_size.restype = ctypes.c_longlong
        for which, (name, args) in enumerate(_ARGS.items()):
            size = lib.film_args_size(which)
            if size != ctypes.sizeof(args):
                raise RuntimeError(f"film.cu: {args.__name__[1:]} is {size} "
                                   f"bytes, its ctypes mirror "
                                   f"{ctypes.sizeof(args)}")
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(name: str, args, n: int, dev) -> bool:
    """Launch kernel ``name`` over ``n`` pixels on ``dev``'s current
    stream; False (and no launch) for no pixels."""
    lib = _load_library()
    if n == 0:
        return False
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, name)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cuda error {err}")
    return True


def _device(x):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("the film's kernels need CUDA tensors")
    return dev


def _dense(x, name, dev, shape, dtype=torch.float32):
    """The pointer of a contiguous tensor of ``shape`` and ``dtype`` on
    ``dev``."""
    if (x.dtype != dtype or x.device != dev or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()} on {x.device}; the kernel takes a "
                         f"contiguous {dtype} {list(shape)} on {dev}")
    return x.data_ptr()


def _film_launch(samples, width, height, spp, inv_order, sample_major,
                 final_img=None, old_weight=None, new_weight=None):
    """film_kernel over ``samples`` [H*W*spp, 3]: the image [H, W, 3] of
    their means, accumulated into ``final_img`` where one is given."""
    global film_launches
    dev = _device(samples)
    n_pix = width * height
    a = _FilmArgs(n_pix=n_pix, spp=spp, sample_major=int(sample_major))
    a.samples = _dense(samples, "sample_light", dev, (n_pix * spp, 3))
    if inv_order is not None:
        a.inv_order = _dense(inv_order, "inv_order", dev, (n_pix,),
                             torch.int64)
    if final_img is not None:
        a.accumulate = 1
        a.final_in = _dense(final_img, "final_img", dev, (height, width, 3))
        if isinstance(old_weight, torch.Tensor):
            a.old_ptr = _dense(old_weight, "old_weight", dev, ())
        else:
            a.old_weight = float(old_weight)
        a.new_weight = float(new_weight)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    a.out = out.data_ptr()
    if _launch("film", a, n_pix, dev):
        film_launches += 1
    return out


def reconstruct_cuda(sample_light, width: int, height: int, spp: int,
                     inv_order=None, sample_major: bool = False):
    """``reconstruct``'s kernel on the current stream."""
    return _film_launch(sample_light, width, height, spp, inv_order,
                        sample_major)


def film_cuda(sample_light, final_img, old_weight, new_weight, width: int,
              height: int, spp: int, inv_order=None,
              sample_major: bool = False):
    """``film``'s kernel on the current stream: reconstruct and accumulate
    in one launch.  A tensor ``old_weight`` is read on the device when
    the kernel runs."""
    return _film_launch(sample_light, width, height, spp, inv_order,
                        sample_major, final_img, old_weight, new_weight)


def accumulate_cuda(final_img, new_img, old_weight, new_weight):
    """``accumulate``'s kernel on the current stream: the film over one
    sample per pixel, ``new_img`` itself."""
    height, width = new_img.shape[:2]
    return _film_launch(new_img.reshape(-1, 3), width, height, 1, None,
                        False, final_img, old_weight, new_weight)


def median_filter_3x3_cuda(img: torch.Tensor,
                           reference_compat: bool = False):
    """``median_filter_3x3``'s kernel on the current stream."""
    global median_launches
    dev = _device(img)
    h, w = img.shape[:2]
    a = _MedianArgs(img=_dense(img, "img", dev, (h, w, 3)), h=h, w=w,
                    compat=int(reference_compat))
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    a.out = out.data_ptr()
    if _launch("median3x3", a, h * w, dev):
        median_launches += 1
    return out


def tonemap(img: torch.Tensor, gamma: float = 2.2, exposure: float = 1.0):
    """HDR -> display mapping."""
    img = 1.0 - torch.exp(-img * exposure)
    return torch.clamp(img, 0.0, 1.0) ** (1.0 / gamma)
