"""Measure conv1 lowering strategies at the sweep's exact hot shapes.

The ligand CNN runs per rotation and its first layer contracts the
11-channel density.  At the hot shape — ``[chunk, 40, 40, 40, 11]``
-> 3x3x3 conv -> 32 channels — this tool times the lowering
candidates on the card, so a lowering is promoted on numbers, not
guesses:

  xla_conv     lax.conv_general_dilated as-is (baseline)
  pad16        zero-pad in-channels 11 -> 16 before the same conv
  patches_gemm lax.conv_general_dilated_patches -> one [N*40^3, 297]
               x [297, 32] GEMM (explicit im2col; XLA may fuse the
               patch extraction)
  ztap_gemm    3 z-taps of [N*40^2*40, 9*11] GEMMs summed (the 3-D
               conv as 3 shifted 2-D im2col GEMMs; smaller patch
               tensor in flight)

Usage: python tools/exp_conv1.py [chunk] [box] [c_in] [c_out]
"""
from __future__ import annotations

import functools
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def xla_conv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        preferred_element_type=jnp.float32)


def pad16(x, w):
    cin = x.shape[-1]
    pad = (-cin) % 16
    xp = jnp.pad(x, [(0, 0)] * 4 + [(0, pad)])
    wp = jnp.pad(w, [(0, 0)] * 3 + [(0, pad), (0, 0)])
    return xla_conv(xp, wp)


def patches_gemm(x, w):
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    p = jax.lax.conv_general_dilated_patches(
        x, (3, 3, 3), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    # patches feature order is (C_in, *kernel_spatial) flattened, so
    # fold w to the matching [cin*kd*kh*kw, cout] (relerr vs xla_conv
    # asserts the ordering).
    wf = w.transpose(3, 0, 1, 2, 4).reshape(-1, cout)
    return (p.reshape(-1, p.shape[-1]) @ wf).reshape(n, d, h, wd, cout)


def ztap_gemm(x, w):
    """3-D conv as 3 z-shifted 2-D convs (each a patches GEMM)."""
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    out = jnp.zeros((n, d, h, wd, cout), jnp.float32)
    for dz in (-1, 0, 1):
        xs = jnp.roll(x, -dz, axis=1)    # xs[z] = x[z + dz]
        # zero the wrapped slab (SAME padding semantics)
        if dz == -1:
            xs = xs.at[:, 0].set(0.0)    # x[-1] wrapped into slab 0
        elif dz == 1:
            xs = xs.at[:, -1].set(0.0)   # x[d] wrapped into slab -1
        w2 = w[dz + 1]                               # [3, 3, cin, cout]
        p = jax.lax.conv_general_dilated_patches(
            xs.reshape(n * d, h, wd, cin), (3, 3), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        wf = w2.transpose(2, 0, 1, 3).reshape(-1, cout)
        out = out + (p.reshape(-1, p.shape[-1]) @ wf).reshape(
            n, d, h, wd, cout)
    return out


def bench(fn, x, w, n_iter=20):
    f = jax.jit(fn)
    r = f(x, w)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        r = f(x, w)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n_iter


def main():
    chunk = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    box = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    cin = int(sys.argv[3]) if len(sys.argv) > 3 else 11
    cout = int(sys.argv[4]) if len(sys.argv) > 4 else 32
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(chunk, box, box, box, cin)),
                    jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(3, 3, 3, cin, cout)) * 0.1,
                    jnp.bfloat16)
    ref = None
    flops = 2 * 27 * cin * cout * box ** 3 * chunk
    for name, fn in [("xla_conv", xla_conv), ("pad16", pad16),
                     ("patches_gemm", patches_gemm),
                     ("ztap_gemm", ztap_gemm)]:
        try:
            out = np.asarray(jax.jit(fn)(x, w), np.float32)
            if ref is None:
                ref = out
                err = 0.0
            else:
                err = float(np.max(np.abs(out - ref))
                            / (np.abs(ref).max() + 1e-6))
            dt = bench(fn, x, w)
            print(f"{name:14s} {dt * 1e3:8.3f} ms/chunk "
                  f"{dt / chunk * 1e3:7.4f} ms/rot "
                  f"{flops / dt / 1e12:6.1f} TF/s  relerr={err:.2e}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — survey tool
            print(f"{name:14s} FAILED: {type(e).__name__}: {e}",
                  flush=True)


if __name__ == "__main__":
    main()
