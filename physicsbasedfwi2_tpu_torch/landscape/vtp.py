"""ParaView VTP export of 2-D loss surfaces (port of
``physicsbasedfwi2_tpu/landscape/vtp.py``, plain numpy).

The role of the reference's ``h52vtp.py`` (``h5_to_vtp``): a VTK-XML
PolyData quad mesh with points (x, y, z=loss), one quad per grid cell,
"zvalue" point scalars and "averaged zvalue" cell scalars, and the
optional log/zmax transforms.  The surface is written from memory (or
the CLI's .npz), the arrays formatted through ``np.savetxt``; for the
same input this writes the same bytes as the JAX package's writer.
"""

from __future__ import annotations

import io

import numpy as np


def _ascii_rows(arr: np.ndarray, per_row: int) -> str:
    """Format a flat array as indented ascii rows, `per_row` per line."""
    flat = np.asarray(arr).ravel()
    if flat.size == 0:
        return ""
    # %.9g round-trips float32 exactly (the declared DataArray type)
    fmt = "%.9g" if flat.dtype.kind == "f" else "%d"
    n_full = (flat.size // per_row) * per_row
    buf = io.StringIO()
    if n_full:
        np.savetxt(buf, flat[:n_full].reshape(-1, per_row), fmt=fmt,
                   delimiter=" ")
    if n_full < flat.size:
        np.savetxt(buf, flat[n_full:][None], fmt=fmt, delimiter=" ")
    return "\n".join("          " + ln
                     for ln in buf.getvalue().rstrip("\n").splitlines())


def surface_to_vtp(path: str, losses: np.ndarray, xs: np.ndarray,
                   ys: np.ndarray, *, log: bool = False,
                   zmax: float = -1.0, name: str = "loss") -> str:
    """Write a loss surface as a VTK-XML PolyData (.vtp) quad mesh.

    losses[j, i] is the value at (xs[i], ys[j]) — the cli.py / reference
    plot convention. Matches h52vtp's output structure: a single Piece
    with ny*nx points at (x, y, z=loss), (ny-1)*(nx-1) quad polys,
    point scalars "zvalue" and cell scalars "averaged zvalue".
    Degenerate (single-row/column) surfaces export as a point cloud
    with zero polys.
    """
    losses = np.asarray(losses, np.float64)
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    ny, nx = losses.shape
    if (ny, nx) != (len(ys), len(xs)):
        raise ValueError(f"losses {losses.shape} vs grid "
                         f"({len(ys)}, {len(xs)})")

    z = losses.copy()
    if zmax > 0:
        z = np.minimum(z, zmax)
    if log:
        z = np.log(z + 0.1)

    xg, yg = np.meshgrid(xs, ys)
    pts = np.stack([xg.ravel(), yg.ravel(), z.ravel()], axis=1)

    # one quad per grid cell: (j,i) (j,i+1) (j+1,i+1) (j+1,i)
    j, i = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1),
                       indexing="ij")
    base = (j * nx + i).ravel()
    conn = np.stack([base, base + 1, base + nx + 1, base + nx],
                    axis=1)
    n_polys = conn.shape[0]
    offsets = 4 * np.arange(1, n_polys + 1, dtype=np.int64)
    cell_avg = (z.ravel()[conn].mean(axis=1) if n_polys
                else np.zeros((0,), np.float64))
    cell_lo = cell_avg.min() if n_polys else 0.0
    cell_hi = cell_avg.max() if n_polys else 0.0
    off_hi = int(offsets[-1]) if n_polys else 0

    parts = [
        '<VTKFile type="PolyData" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">',
        "  <PolyData>",
        f'    <Piece NumberOfPoints="{len(pts)}" NumberOfVerts="0" '
        'NumberOfLines="0" NumberOfStrips="0" '
        f'NumberOfPolys="{n_polys}">',
        "      <PointData>",
        f'        <DataArray type="Float32" Name="{name}" '
        'NumberOfComponents="1" format="ascii" '
        f'RangeMin="{z.min()}" RangeMax="{z.max()}">',
        _ascii_rows(z, 6),
        "        </DataArray>",
        "      </PointData>",
        "      <CellData>",
        f'        <DataArray type="Float32" Name="averaged {name}" '
        'NumberOfComponents="1" format="ascii" '
        f'RangeMin="{cell_lo}" RangeMax="{cell_hi}">',
        _ascii_rows(cell_avg, 6),
        "        </DataArray>",
        "      </CellData>",
        "      <Points>",
        '        <DataArray type="Float32" Name="Points" '
        'NumberOfComponents="3" format="ascii" '
        f'RangeMin="{pts.min()}" RangeMax="{pts.max()}">',
        _ascii_rows(pts, 6),
        "        </DataArray>",
        "      </Points>",
        "      <Polys>",
        '        <DataArray type="Int64" Name="connectivity" '
        f'format="ascii" RangeMin="0" RangeMax="{len(pts) - 1}">',
        _ascii_rows(conn, 12),
        "        </DataArray>",
        '        <DataArray type="Int64" Name="offsets" '
        f'format="ascii" RangeMin="4" RangeMax="{off_hi}">',
        _ascii_rows(offsets, 12),
        "        </DataArray>",
        "      </Polys>",
        "    </Piece>",
        "  </PolyData>",
        "</VTKFile>",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path
