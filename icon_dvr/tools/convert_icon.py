#!/usr/bin/env python
"""convert_icon — offline DWD-ICON NetCDF -> engine-format converter.

Port of the reference tool (ref: tools/convert_icon/convert_icon.cpp):
  convert_icon -hgrid GRID.nc -hsurf HSURF.nc -hhl HHL1.nc [HHL2.nc ...]
               -data D1.nc [D2.nc ...] [-o OUTBASE] [--var NAME]
               [--max-layers N] [--ic] [--umesh] [--wedges]

Behavioral parity:
  * horizontal grid from clat_vertices/clon_vertices (radians, CCW corners;
    ref: convert_icon.cpp:193-204);
  * HHL height-level files sorted by height descending (ref: :236-274);
  * per-level data files min-max normalized to [0, 1] (ref: :317-328);
  * terrain-following radii: H[0] = R + HSURF, H[j] = R + HHL_j - HSURF
    with R = 6.371229e6 m, columns split when layers exceed
    LMAX-1 = 31 per record (ref: :353-391);
  * optional wedge-soup export with 50x vertical exaggeration
    (ref: :393-452) — `--umesh` writes binary .umesh files in the public
    umesh library's saveBinaryUMesh layout (see write_umesh); `--wedges`
    writes the simpler self-describing 'ICWG' format.

grib2 inputs are expected pre-converted with cdo, as in the reference
(ref: convert_icon.cpp:27-42).  NetCDF classic files are parsed by the
built-in reader (icon_dvr.data.netcdf) — no libnetcdf needed;
netCDF-4/HDF5 files require the optional netCDF4 package.
"""
from __future__ import annotations

import struct
import sys

import numpy as np

from ..data.icfile import ICDataset, MAX_LAYERS, write_ic
from ..utils.vecmath import np_to_cartesian

EARTH_RADIUS = np.float32(6.371229e6)   # ref: convert_icon.cpp:359
LMAX = MAX_LAYERS
F = np.float32


def _open(path: str):
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:3] == b"CDF":
        from ..data.netcdf import Dataset
        return Dataset(path)
    try:
        import netCDF4  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            f"{path} is not NetCDF classic and the netCDF4 package is not "
            "available; convert with 'cdo -f nc copy in out' first") from e
    return netCDF4.Dataset(path)


def _get(ds, name):
    arr = np.asarray(ds[name][...] if hasattr(ds[name], "__getitem__")
                     else ds[name])
    return np.squeeze(arr)


def _corner_layout(arr, ncell):
    """Return (ncell, 3) regardless of (3, ncell) / (ncell, 3) storage."""
    if arr.shape == (ncell, 3):
        return arr
    if arr.shape == (3, ncell):
        return arr.T
    raise ValueError(f"unexpected corner-variable shape {arr.shape}")


def convert(hgrid: str, hsurf: str, hhl_files: list[str],
            data_files: list[str], var: str = "pres",
            max_layers: int | None = None):
    """Returns an ICDataset (possibly with split columns)."""
    grid = _open(hgrid)
    ncell = grid.dimensions["cell"] if "cell" in grid.dimensions \
        else _get(grid, "clat_vertices").shape[-1]
    clat = _corner_layout(np.asarray(_get(grid, "clat_vertices"), F), ncell)
    clon = _corner_layout(np.asarray(_get(grid, "clon_vertices"), F), ncell)

    hs = np.asarray(_get(_open(hsurf), "HSURF"), F).reshape(-1)[:ncell]

    hhl = []
    for p in hhl_files:
        lv = np.asarray(_get(_open(p), "HHL"), F)
        lv = lv.reshape(-1)[-ncell:]
        hhl.append(lv)
    # sort levels by height descending (ref: convert_icon.cpp:236-274)
    order = np.argsort([-float(h.mean()) for h in hhl])
    hhl = [hhl[i] for i in order]

    vals = []
    for p in data_files:
        d = _open(p)
        v = np.asarray(_get(d, var), F).reshape(-1)[-ncell:]
        vals.append(v)
    if not vals:
        raise ValueError("no data files")
    allv = np.stack(vals)
    vmin, vmax = float(allv.min()), float(allv.max())
    allv = (allv - vmin) / max(vmax - vmin, 1e-30)   # ref: :317-328

    num_layers = len(vals)
    if max_layers is not None:
        num_layers = min(num_layers, max_layers)
    if len(hhl) < num_layers + 1:
        raise ValueError(f"need {num_layers + 1} HHL levels, got {len(hhl)}")

    # terrain-following radii, ascending per column: H[0] = R + HSURF, then
    # one level boundary per layer (ref: :361-374).  HHL sorted descending =
    # top first; layer j's ceiling is HHL[num_layers - 1 - j].
    ceilings = np.stack([hhl[num_layers - 1 - j] for j in range(num_layers)])
    radii = np.concatenate([
        (EARTH_RADIUS + hs)[None],
        EARTH_RADIUS + ceilings - hs[None, :],
    ])  # (num_layers + 1, ncell)
    layer_vals = np.stack([allv[num_layers - 1 - j] for j in range(num_layers)])

    # split into records of at most LMAX-1 layers (ref: :362-367)
    recs_lat, recs_lon, recs_nl, recs_h, recs_v = [], [], [], [], []
    j = 0
    while j < num_layers:
        nl = min(LMAX - 1, num_layers - j)
        h = np.zeros((ncell, MAX_LAYERS), F)
        v = np.zeros((ncell, MAX_LAYERS), F)
        h[:, :nl + 1] = radii[j:j + nl + 1].T
        v[:, :nl] = layer_vals[j:j + nl].T
        recs_lat.append(clat)
        recs_lon.append(clon)
        recs_nl.append(np.full(ncell, nl, np.int32))
        recs_h.append(h)
        recs_v.append(v)
        j += nl

    return ICDataset(
        lat=np.concatenate(recs_lat), lon=np.concatenate(recs_lon),
        num_layers=np.concatenate(recs_nl),
        height=np.concatenate(recs_h), value=np.concatenate(recs_v))


def wedge_soup(ds: ICDataset, height_scale: float = 50.0):
    """Expand an ICDataset into the reference's wedge soup (one 6-vertex
    wedge per cell layer, bottom/top value both the layer value — the
    reference leaves interpolation as a TODO; ref: convert_icon.cpp:404-441)
    with vertical exaggeration.  Returns (vertices (V,3) f32,
    scalars (V,) f32, indices (Wn,6) i32)."""
    verts, scalars, indices = [], [], []
    base = 0
    for i in range(ds.num_cells):
        nl = int(ds.num_layers[i])
        for h in range(nl):
            r0 = EARTH_RADIUS + (ds.height[i, h] - EARTH_RADIUS) * height_scale
            r1 = EARTH_RADIUS + (ds.height[i, h + 1] - EARTH_RADIUS) * height_scale
            for rr in (r0, r1):
                sph = np.stack([np.full(3, rr, F), ds.lat[i], ds.lon[i]], -1)
                verts.append(np_to_cartesian(sph))
            s = ds.value[i, h]
            scalars.extend([s] * 6)
            indices.append(np.arange(base, base + 6, dtype=np.int32))
            base += 6
    verts = (np.concatenate(verts).astype(F).reshape(-1, 3)
             if verts else np.zeros((0, 3), F))
    scalars = np.asarray(scalars, F)
    indices = np.stack(indices) if indices else np.zeros((0, 6), np.int32)
    return verts, scalars, indices


def write_wedges(path: str, ds: ICDataset, height_scale: float = 50.0):
    """Wedge-soup export with vertical exaggeration (the reference's .umesh
    branch, ref: convert_icon.cpp:393-452).  Our format (little-endian):
      magic 'ICWG', u32 version=1, u64 num_vertices, u64 num_wedges,
      f32 vertices[num_vertices][3], f32 scalars[num_vertices],
      i32 indices[num_wedges][6].
    """
    verts, scalars, indices = wedge_soup(ds, height_scale)
    with open(path, "wb") as f:
        f.write(b"ICWG" + struct.pack("<IQQ", 1, len(verts), len(indices)))
        f.write(verts.tobytes())
        f.write(scalars.tobytes())
        f.write(indices.astype("<i4").tobytes())


def write_umesh(path: str, ds: ICDataset, height_scale: float = 50.0,
                attr_name: str = ""):
    """Binary `.umesh` export (the reference's WITH_UMESH branch,
    ref: convert_icon.cpp:393-452: `umesh::UMesh::saveTo`).

    Layout follows the public umesh library's saveBinaryUMesh
    (github.com/ingowald/umesh, io/UMesh.cpp), little-endian:
      u64 magic = 0x234235566 ("bum" binary-umesh magic),
      then seven size-prefixed arrays (u64 count + raw payload):
        vertices  f32[count][3]
        triangles i32[count][3]
        quads     i32[count][4]
        tets      i32[count][4]
        pyrs      i32[count][5]
        wedges    i32[count][6]
        hexes     i32[count][8]
      then i32 hasPerVertexAttribute; if 1:
        u64 name_len + name bytes, u64 count + f32 values[count].
    The umesh library itself is not vendored (mirrors the reference's
    optional WITH_UMESH) and this environment has no network, so the
    layout cannot be re-verified against upstream here; read_umesh is the
    round-trip check.  convert_icon emits only wedges (one per cell
    layer), like the reference."""
    verts, scalars, indices = wedge_soup(ds, height_scale)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", UMESH_MAGIC))
        f.write(struct.pack("<Q", len(verts)))
        f.write(verts.astype("<f4").tobytes())
        for _ in range(3):                    # triangles, quads, tets
            f.write(struct.pack("<Q", 0))
        f.write(struct.pack("<Q", 0))         # pyrs
        f.write(struct.pack("<Q", len(indices)))
        f.write(indices.astype("<i4").tobytes())
        f.write(struct.pack("<Q", 0))         # hexes
        f.write(struct.pack("<i", 1))
        name = attr_name.encode()
        f.write(struct.pack("<Q", len(name)) + name)
        f.write(struct.pack("<Q", len(scalars)))
        f.write(scalars.astype("<f4").tobytes())


UMESH_MAGIC = 0x234235566


def read_umesh(path: str):
    """Parse a binary .umesh (see write_umesh).  Returns a dict with
    'vertices' (V,3) f32, the six element arrays, and optional
    'attr_name'/'values'."""
    widths = [("triangles", 3), ("quads", 4), ("tets", 4),
              ("pyrs", 5), ("wedges", 6), ("hexes", 8)]
    out = {}
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<Q", f.read(8))
        if magic != UMESH_MAGIC:
            raise ValueError(f"not a binary umesh file: magic {magic:#x}")
        (nv,) = struct.unpack("<Q", f.read(8))
        out["vertices"] = np.frombuffer(
            f.read(nv * 12), "<f4").reshape(nv, 3)
        for name, w in widths:
            (n,) = struct.unpack("<Q", f.read(8))
            out[name] = np.frombuffer(
                f.read(n * 4 * w), "<i4").reshape(n, w)
        (has_attr,) = struct.unpack("<i", f.read(4))
        if has_attr:
            (ln,) = struct.unpack("<Q", f.read(8))
            out["attr_name"] = f.read(ln).decode()
            (n,) = struct.unpack("<Q", f.read(8))
            out["values"] = np.frombuffer(f.read(n * 4), "<f4")
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = {"hgrid": None, "hsurf": None, "hhl": [], "data": [],
           "out": "out", "var": "pres", "max_layers": None,
           "ic": True, "umesh": False, "wedges": False}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-hgrid":
            cfg["hgrid"] = argv[i + 1]; i += 1
        elif a == "-hsurf":
            cfg["hsurf"] = argv[i + 1]; i += 1
        elif a in ("-hhl", "-data"):
            key = a[1:]
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                cfg[key].append(argv[i + 1]); i += 1
        elif a == "-o":
            cfg["out"] = argv[i + 1]; i += 1
        elif a == "--var":
            cfg["var"] = argv[i + 1]; i += 1
        elif a == "--max-layers":
            cfg["max_layers"] = int(argv[i + 1]); i += 1
        elif a == "--umesh":
            cfg["umesh"] = True
        elif a == "--wedges":
            cfg["wedges"] = True
        elif a == "--no-ic":
            cfg["ic"] = False
        i += 1
    if not (cfg["hgrid"] and cfg["hsurf"] and cfg["hhl"] and cfg["data"]):
        print(__doc__, file=sys.stderr)
        return 1
    ds = convert(cfg["hgrid"], cfg["hsurf"], cfg["hhl"], cfg["data"],
                 cfg["var"], cfg["max_layers"])
    if cfg["ic"]:
        write_ic(cfg["out"] + ".ic", ds)
        print(f"wrote {cfg['out']}.ic ({ds.num_cells} records)")
    if cfg["umesh"]:
        write_umesh(cfg["out"] + ".umesh", ds)
        print(f"wrote {cfg['out']}.umesh")
    if cfg["wedges"]:
        write_wedges(cfg["out"] + ".wedges", ds)
        print(f"wrote {cfg['out']}.wedges")
    return 0


if __name__ == "__main__":
    sys.exit(main())
