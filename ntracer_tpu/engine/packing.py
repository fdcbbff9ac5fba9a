"""Channel bit-packing: float RGB -> packed pixel bytes.

Port of ``process_pixel`` (/root/reference/src/render.cpp:396-466): per
channel, ``clamp(f_r*r + f_g*g + f_b*b + f_c, 0, 1)`` is scaled to
``bit_size`` bits (``lround``, half away from zero) or bit-cast when
``tfloat``, then channels pack MSB-first into ``bytes_per_pixel`` bytes;
``reversed`` flips the byte order.

Three implementations with identical bitstreams:

  * ``pack_device_stream`` — jnp/uint32 returning a dense uint32 stream
    (the production frame path; stays in u32 lanes end-to-end).
  * ``pack_device`` — jnp/uint32 returning (R, bpp) uint8 (mesh path and
    tests).  Deviation shared with the stream variant: the bit-scale
    multiply is float32, so channels wider than 23 bits can round
    differently from the reference's double math (the engine routes such
    formats to the host packer, wavefront._needs_host_pack).
  * ``pack_rows``   — NumPy/uint64 host fallback, bit-exact with the
    reference for all widths.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..render import ImageFormat


def format_key(fmt: ImageFormat):
    """Hashable static description of the pixel format for jit."""
    return (tuple((c.bit_size, c.f_r, c.f_g, c.f_b, c.f_c, c.tfloat)
                  for c in fmt.channels),
            fmt.bytes_per_pixel, bool(fmt.reversed))


def _pack_words(colors, key, colors_T=False):
    """Shared channel math: (R, 3) float32 -> list of (R,) uint32 words
    holding each pixel's packed bits MSB-first (JAX has no 64-bit
    integers by default; the MSB-first byte stream across words equals
    the reference's 64-bit-word layout, render.cpp:419-462).

    ``colors_T=True`` accepts (3, R) — channel rows are contiguous lane
    vectors, skipping the relayout of the column slices of an (R, 3)
    array (the transposed shade pipeline produces this shape)."""
    channels, bpp, reverse = key
    if colors_T:
        r, g, b = colors[0], colors[1], colors[2]
        n = colors.shape[1]
    else:
        r, g, b = colors[:, 0], colors[:, 1], colors[:, 2]
        n = colors.shape[0]
    n_words = (bpp + 3) // 4
    words = [jnp.zeros(n, jnp.uint32) for _ in range(n_words)]

    off = 0
    for bit_size, f_r, f_g, f_b, f_c, tfloat in channels:
        val = jnp.clip(np.float32(f_r) * r + np.float32(f_g) * g
                       + np.float32(f_b) * b + np.float32(f_c), 0.0, 1.0)
        if tfloat:
            ival = jax.lax.bitcast_convert_type(val, jnp.uint32)
        else:
            if bit_size <= 23:
                # exact lround(double(val) * scale), scale = 2^b - 1:
                # val * 2^b is exact (exponent shift), so
                # p = fl(val*2^b - val) == fl(val * scale) and the
                # subtraction's error is recovered exactly by a Fast2Sum
                # (valid since val*2^b >= val >= 0) — bit-identical to a
                # Dekker two-product of val*scale at a third of the ops.
                # q = p + 0.5 and its floor are exact because p < 2^23.
                p_hi = val * np.float32(1 << bit_size)
                p = p_hi - val
                err = (p_hi - p) - val
                q = p + np.float32(0.5)
                i0 = jnp.floor(q)
                frac = (q - i0) + err
                i0 = i0 + (frac >= 1).astype(jnp.float32) \
                    - (frac < 0).astype(jnp.float32)
                ival = i0.astype(jnp.uint32)
            else:
                # >23-bit channels: the scale product exceeds the float32
                # significand; documented deviation vs the reference's
                # double math (neighbouring codes only)
                scale = np.float32(0xFFFFFFFF >> (32 - bit_size))
                ival = jnp.floor(val * scale + 0.5).astype(jnp.uint32)
        o = off // 32
        rm = off % 32
        s = 32 - rm - bit_size
        if s >= 0:
            words[o] = words[o] | (ival << np.uint32(s))
        else:
            words[o] = words[o] | (ival >> np.uint32(-s))
        if rm + bit_size > 32:
            words[o + 1] = words[o + 1] | (ival << np.uint32(64 - rm - bit_size))
        off += bit_size
    return words


@partial(jax.jit, static_argnames=("key",))
def pack_device(colors, key):
    """Device-side packing: (R, 3) float32 -> (R, bpp) uint8."""
    channels, bpp, reverse = key
    words = _pack_words(colors, key)
    byte_order = range(bpp - 1, -1, -1) if reverse else range(bpp)
    out = [((words[j // 4] >> np.uint32(8 * (3 - (j % 4)))) & np.uint32(0xFF))
           .astype(jnp.uint8) for j in byte_order]
    return jnp.stack(out, axis=1)


@partial(jax.jit, static_argnames=("key", "permute", "colors_T"))
def pack_device_stream(colors, key, permute=None, colors_T=False):
    """Device-side packing to a dense uint32 stream: (R, 3) float32 ->
    (R//4, bpp) uint32 whose little-endian byte stream is identical to
    ``pack_device``'s (R, bpp) uint8 output (groups of 4 pixels = bpp
    words).  Staying in uint32 lanes skips pack_device's per-byte uint8
    extract + stack relayout.  Requires R % 4 == 0.

    ``permute`` (optional) reorders PIXELS between the per-pixel word
    pack and the 4-pixel stream grouping: it receives an (R, k) array
    and returns it row-permuted (the tile unswizzle).  Permuting the
    packed words instead of the float colors moves one (R, 3) f32
    relayout to an (R, ~1) u32 one — bit-identical output because the
    word pack is per-pixel."""
    channels, bpp, reverse = key
    R = colors.shape[1] if colors_T else colors.shape[0]
    assert R % 4 == 0, "pack_device_stream needs a multiple of 4 pixels"
    words = _pack_words(colors, key, colors_T=colors_T)
    if permute is not None:
        words = [permute(w[:, None])[:, 0] for w in words]
    wr = [w.reshape(-1, 4) for w in words]  # (R//4, 4 px per group)
    byte_order = list(range(bpp - 1, -1, -1) if reverse else range(bpp))
    out = []
    for w_idx in range(bpp):            # output u32 word within the group
        acc = jnp.zeros(R // 4, jnp.uint32)
        for k in range(4):              # little-endian byte k of the word
            i = 4 * w_idx + k           # byte index within the group
            p, jj = divmod(i, bpp)      # pixel in group, byte in pixel
            j = byte_order[jj]
            byt = (wr[j // 4][:, p] >> np.uint32(8 * (3 - (j % 4)))) \
                & np.uint32(0xFF)
            acc = acc | (byt << np.uint32(8 * k))
        out.append(acc)
    return jnp.stack(out, axis=1)


def pack_flat(colors: np.ndarray, fmt: ImageFormat) -> np.ndarray:
    """Host packing of a flat color slab: (N, 3) float32 -> (N, bpp) uint8.

    Used when the engine routes a wide-channel format (>23-bit integer
    channels) around the device packer: the dispatch ships raw floats and
    this packs them with the reference's exact 64-bit math."""
    n = colors.shape[0]
    return pack_rows(colors.reshape(1, n, 3), fmt).reshape(
        n, fmt.bytes_per_pixel)


def pack_rows(colors: np.ndarray, fmt: ImageFormat) -> np.ndarray:
    """Host packing: (rows, W, 3) float32 -> (rows, W*bpp) uint8."""
    rows, w, _ = colors.shape
    n = rows * w
    c = np.asarray(colors, dtype=np.float32).reshape(n, 3)
    bpp = fmt.bytes_per_pixel

    temp = np.zeros((n, 2), dtype=np.uint64)
    b_offset = 0
    for ch in fmt.channels:
        val = np.clip(ch.f_r * c[:, 0] + ch.f_g * c[:, 1] + ch.f_b * c[:, 2]
                      + np.float32(ch.f_c), 0.0, 1.0).astype(np.float32)
        if ch.tfloat:
            ival = val.view(np.uint32).astype(np.uint64)
        else:
            scale = np.float64(0xFFFFFFFF >> (32 - ch.bit_size))
            # std::lround: round half away from zero (values here are >= 0)
            ival = np.floor(val.astype(np.float64) * scale + 0.5).astype(np.uint64)

        o = b_offset // 64
        rm = b_offset % 64
        s = 64 - rm - ch.bit_size
        if s >= 0:
            temp[:, o] |= ival << np.uint64(s)
        else:
            temp[:, o] |= ival >> np.uint64(-s)
        if rm + ch.bit_size > 64:
            temp[:, o + 1] = ival << np.uint64(128 - rm - ch.bit_size)
        b_offset += ch.bit_size

    # big-endian byte extraction (render.cpp:449-461)
    out = np.empty((n, bpp), dtype=np.uint8)
    byte_order = range(bpp - 1, -1, -1) if fmt.reversed else range(bpp)
    for out_j, j in enumerate(byte_order):
        word = temp[:, j // 8]
        shift = np.uint64((8 - 1 - (j % 8)) * 8)
        out[:, out_j] = (word >> shift).astype(np.uint8)

    return out.reshape(rows, w * bpp)
