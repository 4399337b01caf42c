#!/usr/bin/env python
"""Real-data ingest, end to end.

The reference's entire purpose is rendering DWD ICON NetCDF output
(ref: tools/convert_icon/convert_icon.cpp:163-452).  No real DWD download
exists in this offline environment, so this script builds an R2B7-SCALE
(327,680-column, 16-level) NetCDF dataset in the exact DWD layout the
converter expects — icosahedral clat/clon_vertices horizontal grid, HSURF
terrain, one HHL file per height level, one data file per level with a
'pres' variable — and then exercises the full production path on it:

  NetCDF -> convert_icon CLI -> .ic -> read_ic -> quantize -> locator
         -> device render -> PNG

printing the wall-clock of every stage.  Run:  python scripts/e2e_netcdf.py
[--subdiv 7] [--levels 16] [--workdir DIR] [--samples 16] [--spp 8]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_netcdf_inputs(workdir: str, subdiv: int, levels: int):
    """DWD-layout NetCDF files from a synthetic icosahedral grid: the
    horizontal grid matches ICON's (triangular cells, radian corner
    coordinates, (nv, cell) transposed layout like real DWD grid files),
    HSURF is smooth terrain, HHL are terrain-following height levels
    sorted TOP-FIRST like real model output, 'pres' is a banded wave."""
    from scipy.io import netcdf_file

    from icon_dvr.data.synthetic import _default_field, icosphere

    ds = icosphere(subdivisions=subdiv, num_layers=1)   # geometry only
    ncell = ds.num_cells
    lat, lon = ds.lat, ds.lon

    os.makedirs(workdir, exist_ok=True)

    def write(path, dims, variables, version=2):
        f = netcdf_file(path, "w", version=version)
        for n, s in dims.items():
            f.createDimension(n, s)
        for name, (dimnames, data) in variables.items():
            v = f.createVariable(name, data.dtype.newbyteorder(">"), dimnames)
            v[:] = data
        f.close()

    hgrid = os.path.join(workdir, "icon_grid.nc")
    # (nv, cell) — the transposed layout of real DWD grid files
    write(hgrid, {"nv": 3, "cell": ncell},
          {"clat_vertices": (("nv", "cell"), lat.T.astype(np.float32)),
           "clon_vertices": (("nv", "cell"), lon.T.astype(np.float32))})

    clat = lat.mean(axis=1)
    clon = np.arctan2(np.sin(lon).mean(axis=1), np.cos(lon).mean(axis=1))
    hsurf_v = (600.0 + 500.0 * np.sin(2 * clat) * np.cos(3 * clon)
               ).astype(np.float32)
    hsurf = os.path.join(workdir, "hsurf.nc")
    write(hsurf, {"cell": ncell}, {"HSURF": (("cell",), hsurf_v)})

    top = 30000.0
    hhl_files, data_files = [], []
    for k in range(levels + 1):
        # level k of levels+1, top (30 km) first like real HHL output
        frac = 1.0 - k / levels
        h = (hsurf_v + (top - hsurf_v) * frac).astype(np.float32)
        p = os.path.join(workdir, f"hhl_{k:02d}.nc")
        write(p, {"cell": ncell}, {"HHL": (("cell",), h)})
        hhl_files.append(p)
    for k in range(levels):
        depth = np.float32(1.0 - (k + 0.5) / levels)  # top-first like HHL
        v = _default_field(clat.astype(np.float32),
                           clon.astype(np.float32), depth)
        # give it a pressure-like magnitude so normalization is exercised
        v = (50000.0 + 45000.0 * v).astype(np.float32)
        p = os.path.join(workdir, f"pres_{k:02d}.nc")
        write(p, {"cell": ncell}, {"pres": (("cell",), v)})
        data_files.append(p)
    return hgrid, hsurf, hhl_files, data_files


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=7)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".cache", "e2e"))
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--spp", type=int, default=8,
                    help="progressive samples per launch")
    ap.add_argument("--png", default="docs/images/e2e_netcdf_r2b7.png")
    args = ap.parse_args()

    t0 = time.time()
    hgrid, hsurf, hhl, data = make_netcdf_inputs(args.workdir, args.subdiv,
                                                 args.levels)
    nc_bytes = sum(os.path.getsize(p) for p in [hgrid, hsurf] + hhl + data)
    print(f"[1] NetCDF fixture: {len(hhl)} HHL + {len(data)} data files, "
          f"{nc_bytes/1e6:.0f} MB, {time.time()-t0:.1f}s", flush=True)

    from icon_dvr.tools import convert_icon as ci

    t0 = time.time()
    out = os.path.join(args.workdir, "r2b7")
    rc = ci.main(["-hgrid", hgrid, "-hsurf", hsurf, "-hhl", *hhl,
                  "-data", *data, "-o", out])
    assert rc == 0
    ic_path = out + ".ic"
    print(f"[2] convert_icon -> .ic: {os.path.getsize(ic_path)/1e6:.0f} MB, "
          f"{time.time()-t0:.1f}s", flush=True)

    from icon_dvr.data.icfile import read_ic

    t0 = time.time()
    ds = read_ic(ic_path)
    print(f"[3] read_ic: {ds.num_cells} columns, "
          f"{int(ds.num_layers.max())} layers, {time.time()-t0:.1f}s",
          flush=True)

    from icon_dvr.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from icon_dvr.models.cells import compute_stats
    from icon_dvr.models.locator import build_locator_csr, densify_csr
    from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                        quantize_dataset_values)
    from icon_dvr.models.shells import (build_radial_bands,
                                        update_band_majorants)
    from icon_dvr.models.transfunc import make_transfunc

    t0 = time.time()
    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range))
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi)), tf)
    bands = update_band_majorants(build_radial_bands(ds_q, 64),
                                  tf.values, tf.value_range)
    print(f"[4] quantize + bake + bands: lm={q.lm}, {time.time()-t0:.1f}s",
          flush=True)

    t0 = time.time()
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    print(f"[5] locator: {int(np.prod(np.asarray(loc.dims)))} bins, "
          f"k_cap={k_cap}, {time.time()-t0:.1f}s", flush=True)

    import jax.numpy as jnp

    from icon_dvr.ops.camera import Camera
    from icon_dvr.ops.fastq import render_frame_fast_q
    from icon_dvr.ops.order import inverse_order, pixel_order
    from icon_dvr.ops.render import (alloc_frame, fb_to_image,
                                     make_launch_params)
    from icon_dvr.utils.png import write_png

    W, H = args.width, args.height
    cam = Camera()
    cam.set_aspect(W / H)
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    r_out = float(stats.spherical_bounds_hi[0])
    theta = np.arctan(1.15 * np.tan(0.5 * cam.fovy))
    d = r_out / np.sin(theta)
    direction = np.array([2.2, 0.4, 0.9], np.float32)
    direction /= np.linalg.norm(direction)
    cam.set_orientation(center + direction * d, center,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    unit_distance = 10.0 ** (np.floor(
        np.log10(stats.spherical_bounds_lo[0])) - 3)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi,
                            unit_distance=unit_distance)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], W, H)
    inv = inverse_order(perm)
    perm_d = jnp.asarray(perm)
    accum, fb = alloc_frame(W, H)

    t0 = time.time()
    done = 0
    while done < args.samples:
        n = min(args.spp, args.samples - done)
        accum, fb = render_frame_fast_q(
            q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(done)),
            accum, fb, width=W, height=H, pixel_perm=perm_d,
            n_active=n_active, samples=n)
        done += n
    img = np.asarray(fb)[inv]
    dt = time.time() - t0
    print(f"[6] render {args.samples} samples @ {W}x{H}: {dt:.1f}s "
          f"({W*H*args.samples/dt/1e6:.2f} Mray/s full incl. compile), "
          f"coverage {(img != 0).mean():.3f}", flush=True)

    os.makedirs(os.path.dirname(args.png), exist_ok=True)
    write_png(args.png, fb_to_image(img, W, H, bgcolor=(0.05, 0.05, 0.08)))
    print(f"[7] wrote {args.png}", flush=True)


if __name__ == "__main__":
    main()
