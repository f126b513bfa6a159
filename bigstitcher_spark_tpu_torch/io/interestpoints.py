"""interestpoints.n5 store: detected points + correspondences per (view, label).

Port of ``bigstitcher_spark_tpu/io/interestpoints.py`` on the port's numpy
:mod:`.chunkstore`, with the same on-disk layout, so either package reads
what the other wrote. The schema matches the reference (mvrecon
``InterestPointsN5``; layout visible in SpimData2Util.java:49-162) so the
BigStitcher GUI stays the oracle:

    interestpoints.n5/tpId_{t}_viewSetupId_{s}/{label}/
        interestpoints/id    uint64  [1, N]   (dim0 = component, dim1 = point)
        interestpoints/loc   float64 [3, N]
        correspondences/data uint64  [3, M]   rows = (idA, idB, pairCode)
          attrs: "correspondences": version str,
                 "idMap": {"tp,setup,label": pairCode}

The XML's ``<ViewInterestPointsFile>`` elements point at the per-view group
path (``InterestPointLookup.path`` in io.spimdata).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .chunkstore import ChunkStore, StorageFormat
from .spimdata import InterestPointLookup, SpimData, ViewId

BLOCK = 30000  # points per storage block (reference default block size ~300k/10)


def view_group(view: ViewId, label: str) -> str:
    return f"tpId_{view.timepoint}_viewSetupId_{view.setup}/{label}"


@dataclass
class CorrespondingPoint:
    """One correspondence of a detection in the owning (view, label) to a
    detection in another (view, label) (mvrecon CorrespondingInterestPoints)."""

    id: int
    other_view: ViewId
    other_label: str
    other_id: int


class InterestPointStore:
    def __init__(self, root: str):
        self.root = str(root)
        if os.path.isdir(self.root):
            self.store = ChunkStore.open(self.root)
        else:
            self.store = ChunkStore.create(self.root, StorageFormat.N5)

    @staticmethod
    def for_project(sd: SpimData) -> "InterestPointStore":
        base = os.path.dirname(sd.xml_path or ".")
        return InterestPointStore(os.path.join(base, "interestpoints.n5"))

    # ----------------------------------------------------------------- points

    def save_points(
        self,
        view: ViewId,
        label: str,
        locs: np.ndarray,
        ids: np.ndarray | None = None,
        intensities: np.ndarray | None = None,
    ) -> str:
        """Write N detections; returns the group path for the XML lookup."""
        locs = np.asarray(locs, dtype=np.float64).reshape(-1, 3)
        n = len(locs)
        if ids is None:
            ids = np.arange(n, dtype=np.uint64)
        grp = view_group(view, label)
        base = f"{grp}/interestpoints"
        for sub in (base, f"{grp}/intensities"):
            if self.store.exists(sub):
                self.store.remove(sub)
        # xyz-first logical order: dataset dims (component, point)
        did = self.store.create_dataset(
            f"{base}/id", (1, max(n, 1)), (1, BLOCK), "uint64"
        )
        dloc = self.store.create_dataset(
            f"{base}/loc", (3, max(n, 1)), (3, BLOCK), "float64"
        )
        if n:
            did.write(np.asarray(ids, np.uint64).reshape(1, n), (0, 0))
            dloc.write(locs.T.copy(), (0, 0))
        self.store.set_attribute(base, "pointcloud", "1.0.0")
        self.store.set_attribute(base, "type", "list")
        # datasets are padded to >=1 row; record the true count
        self.store.set_attribute(base, "numPoints", int(n))
        if intensities is not None and n:
            dint = self.store.create_dataset(
                f"{grp}/intensities/i", (1, n), (1, BLOCK), "float64"
            )
            dint.write(np.asarray(intensities, np.float64).reshape(1, n), (0, 0))
        return grp

    def load_points(self, view: ViewId, label: str) -> tuple[np.ndarray, np.ndarray]:
        """-> (ids (N,) uint64, locs (N,3) float64); empty arrays if absent."""
        base = f"{view_group(view, label)}/interestpoints"
        if not self.store.is_dataset(f"{base}/id"):
            return np.zeros(0, np.uint64), np.zeros((0, 3))
        ids = self.store.open_dataset(f"{base}/id").read_full()[0]
        locs = self.store.open_dataset(f"{base}/loc").read_full().T
        # our empty saves are padded to one zero row; "numPoints" records the
        # true count (absent on foreign stores, whose datasets are exact-size)
        n = self.store.get_attribute(base, "numPoints", None)
        if n is not None:
            ids, locs = ids[: int(n)], locs[: int(n)]
        return ids.astype(np.uint64), locs.astype(np.float64)

    # -------------------------------------------------------------- correspondences

    def save_correspondences(
        self, view: ViewId, label: str, corrs: list[CorrespondingPoint]
    ) -> None:
        grp = view_group(view, label)
        base = f"{grp}/correspondences"
        if self.store.exists(base):
            self.store.remove(base)
        id_map: dict[str, int] = {}
        rows = np.zeros((3, max(len(corrs), 1)), dtype=np.uint64)
        for i, c in enumerate(corrs):
            key = f"{c.other_view.timepoint},{c.other_view.setup},{c.other_label}"
            code = id_map.setdefault(key, len(id_map))
            rows[:, i] = (c.id, c.other_id, code)
        d = self.store.create_dataset(
            f"{base}/data", rows.shape, (3, BLOCK), "uint64"
        )
        if corrs:
            d.write(rows, (0, 0))
        self.store.set_attribute(base, "correspondences", "1.0.0")
        self.store.set_attribute(base, "idMap", id_map)

    def load_correspondences(self, view: ViewId, label: str) -> list[CorrespondingPoint]:
        base = f"{view_group(view, label)}/correspondences"
        if not self.store.is_dataset(f"{base}/data"):
            return []
        id_map = self.store.get_attribute(base, "idMap", {}) or {}
        if not id_map:
            return []
        decode = {}
        for key, code in id_map.items():
            tp, setup, lab = key.split(",", 2)
            decode[int(code)] = (ViewId(int(tp), int(setup)), lab)
        rows = self.store.open_dataset(f"{base}/data").read_full()
        out = []
        for ida, idb, code in rows.T.tolist():
            ov, ol = decode[code]
            out.append(CorrespondingPoint(ida, ov, ol, idb))
        return out

    def clear_correspondences(self, view: ViewId, label: str) -> None:
        base = f"{view_group(view, label)}/correspondences"
        if self.store.exists(base):
            self.store.remove(base)

    def remove_view(self, view: ViewId, label: str | None = None) -> None:
        """Delete one label (or the whole view group) — ClearInterestPoints."""
        grp = view_group(view, label) if label else f"tpId_{view.timepoint}_viewSetupId_{view.setup}"
        if self.store.exists(grp):
            self.store.remove(grp)


def register_points_in_xml(
    sd: SpimData, view: ViewId, label: str, params: str, group_path: str
) -> None:
    """Record the store pointer in the project XML (InterestPointTools role)."""
    sd.interest_points.setdefault(view, {})[label] = InterestPointLookup(
        label=label, params=params, path=group_path
    )
