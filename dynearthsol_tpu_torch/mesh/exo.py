"""3D mesh import from ExodusII files (meshing_option 95; counterpart of
dynearthsol_tpu/mesh/exo.py).

The reference links SEACAS/ExodusII (new_mesh_from_exofile,
mesh.cxx:2231-2487).  ExodusII files are NetCDF; the classic (NetCDF-3)
files written by Cubit/SEACAS read directly with scipy.io.netcdf_file, so
no native library is needed.

Layout read (matching the reference):
  - coordx/coordy/coordz            node coordinates
  - connectN (1-based), eb_prop1    element blocks; regattr = block_id - 1
  - elem_ssN/side_ssN, ss_prop1     side sets; segflag = side-set id
    (the id IS the boundary bit: 1=x0, 2=x1, 4=y0, 8=y1, 16=z0, 32=z1)
  - facet-local corner table per "Exodus: A finite element data model"
    Table 4.2 (mesh.cxx:2459: {{1,2,4},{2,3,4},{1,4,3},{1,3,2}})
"""

from __future__ import annotations

import numpy as np

from .generate import MeshData, _orient_3d

# 1-based local corner ids of tet side s (Exodus Table 4.2)
_SIDE_NODES = np.array([[1, 2, 4], [2, 3, 4], [1, 4, 3], [1, 3, 2]]) - 1


def mesh_from_exofile(param) -> MeshData:
    from scipy.io import netcdf_file

    m = param.mesh
    f = netcdf_file(m.exo_filename, mmap=False)
    dims = f.dimensions
    num_dim = int(dims["num_dim"])
    if num_dim != 3:
        raise NotImplementedError("Exodus import is 3D only (mesh.cxx:2234)")
    coord = np.stack([f.variables["coordx"][:].astype(np.float64),
                      f.variables["coordy"][:].astype(np.float64),
                      f.variables["coordz"][:].astype(np.float64)], axis=1)

    nblk = int(dims["num_el_blk"])
    blk_ids = f.variables["eb_prop1"][:].astype(int)
    conns, regattr = [], []
    for b in range(nblk):
        c = f.variables[f"connect{b + 1}"][:].astype(np.int32)
        if c.shape[1] != 4:
            raise ValueError("Exodus element blocks must be tetrahedral")
        conns.append(c - 1)
        regattr.append(np.full(c.shape[0], blk_ids[b] - 1, dtype=np.int32))
    conn = np.concatenate(conns, axis=0)
    regattr = np.concatenate(regattr)

    # side sets -> boundary segments + flags
    nss = int(dims.get("num_side_sets", 0) or 0)
    ss_ids = (f.variables["ss_prop1"][:].astype(int) if nss else
              np.zeros(0, int))
    segs, flags = [], []
    for i in range(nss):
        elems = f.variables[f"elem_ss{i + 1}"][:].astype(int) - 1
        sides = f.variables[f"side_ss{i + 1}"][:].astype(int) - 1
        segs.append(conn[elems[:, None], _SIDE_NODES[sides]])
        flags.append(np.full(elems.shape[0], ss_ids[i], dtype=np.int32))
    segment = (np.concatenate(segs, axis=0) if segs
               else np.zeros((0, 3), dtype=np.int32))
    segflag = (np.concatenate(flags) if flags
               else np.zeros(0, dtype=np.int32))
    f.close()

    # keep segment node triplets consistent with the orientation fix
    conn_oriented = _orient_3d(coord, conn)
    return MeshData(3, coord, conn_oriented, regattr=regattr,
                    segment=segment.astype(np.int32), segflag=segflag)
