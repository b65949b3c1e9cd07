"""fluentMeshToFoam: the Fluent ASCII .msh reader (a host copy of
openfoam-2.2.x_tpu/apps/fluent.py, unchanged in behaviour; the
reference module is loaded through the JAX package). A direct
section-stream parser of the ASCII Fluent mesh format:

  (2 d)                  dimension
  (10 (zone first last type nd) ( x y z ... ))   nodes
  (12 (zone first last type elemtype))           cells (counts only)
  (13 (zone first last type facetype) ( nv v1..vn owner nbr ... ))
  (39/45 (zone type name)(...))                  zone names

Fluent faces carry owner/neighbour directly, which maps 1:1 onto the
face-addressed PolyMesh: interior faces (neighbour != 0) become
internal faces; each boundary zone becomes a patch. Fluent's
right-hand convention points the normal from cell1 (owner) to cell2 —
when the Fluent owner is 0 the face is flipped so the kept cell owns
it, matching the polyMesh owner rule. A 2D mesh (dimension 2) raises,
as in the reference: export a 3D, one-cell-thick mesh."""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from ..mesh.core import Patch, PolyMesh


def _tokens(body: str):
    return body.replace("(", " ( ").replace(")", " ) ").split()


def _parse_sections(text: str):
    """Yield (index, header_args, body_str)."""
    i = 0
    n = len(text)
    while i < n:
        if text[i] != "(":
            i += 1
            continue
        # section index
        m = re.match(r"\((\d+)", text[i:])
        if not m:
            i += 1
            continue
        idx = int(m.group(1))
        j = i + m.end()
        # find the balanced extent of this section
        depth = 1
        k = j
        while k < n and depth:
            if text[k] == "(":
                depth += 1
            elif text[k] == ")":
                depth -= 1
            k += 1
        yield idx, text[j:k - 1]
        i = k


def _split_header_body(content: str) -> Tuple[List[str], str]:
    content = content.strip()
    if not content.startswith("("):
        return content.split(), ""
    depth = 0
    for k, ch in enumerate(content):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                hdr = content[1:k]
                return hdr.split(), content[k + 1:].strip()
    return content.strip("()").split(), ""


def read_fluent(path: str) -> PolyMesh:
    text = open(path).read()
    # strip comment sections in place is handled by the index filter
    dim = 3
    points = None
    faces: List[Tuple[List[int], int, int, int]] = []   # pts,o,n,zone
    zone_names: Dict[int, Tuple[str, str]] = {}
    n_cells = 0

    for idx, content in _parse_sections(text):
        if idx == 2:
            dim = int(content.split()[0])
        elif idx == 10:
            hdr, body = _split_header_body(content)
            zone = int(hdr[0], 16)
            first, last = int(hdr[1], 16), int(hdr[2], 16)
            if zone == 0:
                points = np.zeros((last, 3))
                continue
            if body:
                nums = re.findall(r"[-+0-9.eE]+",
                                  body.split("(", 1)[-1].rsplit(")",
                                                                1)[0])
                arr = np.asarray([float(x) for x in nums])
                nd = dim
                arr = arr.reshape(-1, nd)
                if points is None:
                    points = np.zeros((last, 3))
                points[first - 1:last, :nd] = arr
        elif idx == 12:
            hdr, _ = _split_header_body(content)
            zone = int(hdr[0], 16)
            last = int(hdr[2], 16)
            if zone != 0:
                n_cells = max(n_cells, last)
            else:
                n_cells = max(n_cells, last)
        elif idx == 13:
            hdr, body = _split_header_body(content)
            zone = int(hdr[0], 16)
            if zone == 0 or not body:
                continue
            ftype = int(hdr[4], 16) if len(hdr) > 4 else 0
            toks = [int(t, 16) for t in re.findall(
                r"[0-9a-fA-F]+",
                body.split("(", 1)[-1].rsplit(")", 1)[0])]
            pos = 0
            while pos < len(toks):
                if ftype == 0:          # mixed: leading vertex count
                    nv = toks[pos]
                    pos += 1
                else:
                    nv = ftype
                pts = toks[pos:pos + nv]
                pos += nv
                o, nb = toks[pos], toks[pos + 1]
                pos += 2
                faces.append(([p - 1 for p in pts], o - 1, nb - 1,
                              zone))
        elif idx in (39, 45):
            hdr, _ = _split_header_body(content)
            zone = int(hdr[0])
            ztype = hdr[1]
            name = hdr[2] if len(hdr) > 2 else f"zone{zone}"
            zone_names[zone] = (name, ztype)

    if points is None or not faces:
        raise ValueError("fluentMeshToFoam: no nodes/faces found")

    # ---- owner orientation: polyMesh owner must exist; flip if o < 0 --------
    internal, by_zone = [], {}
    for pts, o, nb, zone in faces:
        if o < 0:                 # flipped boundary face
            pts, o, nb = pts[::-1], nb, o
        if nb >= 0:
            internal.append((pts, o, nb))
        else:
            by_zone.setdefault(zone, []).append((pts, o))

    # Fluent normal points owner -> neighbour already (cell1 -> cell2)
    all_faces = [f[0] for f in internal]
    owner = [f[1] for f in internal]
    neighbour = [f[2] for f in internal]
    patches = []
    start = len(internal)
    for zone in sorted(by_zone):
        fs = by_zone[zone]
        name, ztype = zone_names.get(zone, (f"zone{zone}", "wall"))
        ptype = {"wall": "wall", "symmetry": "symmetry",
                 "pressure-outlet": "patch", "velocity-inlet": "patch",
                 "pressure-inlet": "patch",
                 "interior": "patch"}.get(ztype, "patch")
        patches.append(Patch(name=name, type=ptype, start=start,
                             size=len(fs)))
        for pts, o in fs:
            all_faces.append(pts)
            owner.append(o)
        start += len(fs)

    if dim == 2:
        raise ValueError("fluentMeshToFoam: 2D Fluent meshes are not "
                         "supported — export a 3D (one-cell-thick) "
                         "mesh")

    mx = max(len(f) for f in all_faces)
    fp = np.full((len(all_faces), mx), -1, dtype=np.int64)
    fn = np.empty(len(all_faces), dtype=np.int64)
    for i, f in enumerate(all_faces):
        fp[i, :len(f)] = f
        fn[i] = len(f)
    pm = PolyMesh(points=points, face_pts=fp, face_npts=fn,
                  owner=np.asarray(owner, np.int64),
                  neighbour=np.asarray(neighbour, np.int64),
                  patches=patches)
    # canonical orientation: owner < neighbour with the normal out of
    # the owner (Fluent guarantees the direction; enforce owner<nbr)
    return _canonicalise(pm)


def _canonicalise(pm: PolyMesh) -> PolyMesh:
    """Ensure owner < neighbour on internal faces (flip otherwise) and
    positive volumes (flip faces whose normal points into the owner)."""
    nif = pm.n_internal_faces
    fp = pm.face_pts.copy()
    own = pm.owner.copy()
    nbr = pm.neighbour.copy()
    for f in range(nif):
        if own[f] > nbr[f]:
            own[f], nbr[f] = nbr[f], own[f]
            k = pm.face_npts[f]
            fp[f, :k] = fp[f, :k][::-1]
    pm2 = PolyMesh(points=pm.points, face_pts=fp,
                   face_npts=pm.face_npts, owner=own, neighbour=nbr,
                   patches=pm.patches)
    # orientation fix: normal must point owner -> neighbour
    d = pm2.c[nbr] - pm2.c[own[:nif]]
    bad = np.einsum("fd,fd->f", pm2.sf[:nif], d) < 0
    if bad.any():
        for f in np.where(bad)[0]:
            k = pm2.face_npts[f]
            fp[f, :k] = fp[f, :k][::-1]
        pm2 = PolyMesh(points=pm.points, face_pts=fp,
                       face_npts=pm.face_npts, owner=own,
                       neighbour=nbr, patches=pm.patches)
    return pm2
