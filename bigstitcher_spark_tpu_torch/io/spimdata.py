"""SpimData2 project model: BigStitcher-compatible XML load/save.

Port of ``bigstitcher_spark_tpu/io/spimdata.py`` for local paths: the
same element shapes and order, so a project saved here is byte-identical
to the JAX package's ``SpimData.save`` output.

The XML project file is the shared state of the whole pipeline (reference:
spim_data + mvrecon ``SpimData2``/``XmlIoSpimData2``, loaded per stage at
AbstractBasic.java:49-70 and per executor at util/Spark.java:243-265). This
module re-implements the project model natively: view setups with
angle/channel/illumination/tile attributes, per-view affine transform chains,
missing views, interest-point lookups, bounding boxes, and stitching results.

Element shapes follow the spim_data XML schema (SpimData version="0.2") so the
BigStitcher GUI remains the oracle for our outputs. Unknown sections and
unknown image-loader formats are preserved verbatim on round-trip.

Axis order: xyz everywhere; affines are 3x4 row-major (see utils.geometry).
A transform chain's FIRST element is the OUTERMOST (last-applied) transform,
matching ``ViewRegistration.getModel()`` semantics.
"""

from __future__ import annotations

import copy
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from ..utils.geometry import (
    Interval,
    affine_from_flat,
    affine_to_flat,
    concatenate_all,
    identity_affine,
)

VIEW_ATTRIBUTES = ("illumination", "channel", "tile", "angle")
# XML element tag per attribute name inside <Attributes name="...">
_ATTR_TAG = {
    "illumination": "Illumination",
    "channel": "Channel",
    "tile": "Tile",
    "angle": "Angle",
}


@dataclass(frozen=True, order=True)
class ViewId:
    timepoint: int
    setup: int

    def __str__(self):
        return f"(tp={self.timepoint}, setup={self.setup})"


@dataclass
class AttributeEntity:
    id: int
    name: str
    # tile location (3 doubles) / angle rotation axis+degrees, when present
    extra: dict = field(default_factory=dict)


@dataclass
class ViewSetup:
    id: int
    name: str
    size: tuple[int, int, int]  # xyz
    voxel_unit: str = "um"
    voxel_size: tuple[float, float, float] = (1.0, 1.0, 1.0)
    attributes: dict[str, int] = field(default_factory=dict)  # attr name -> entity id


@dataclass
class ViewTransform:
    name: str
    affine: np.ndarray  # 3x4

    def copy(self) -> "ViewTransform":
        return ViewTransform(self.name, self.affine.copy())


@dataclass
class ImageLoader:
    """Structured for known formats; raw element preserved otherwise."""

    format: str = "bdv.n5"
    path: str = "dataset.n5"  # relative to the XML, or absolute
    path_type: str = "relative"
    raw: ET.Element | None = None  # verbatim passthrough for unknown formats


@dataclass
class InterestPointLookup:
    """Pointer from the XML into interestpoints.n5 (one label of one view)."""

    label: str
    params: str = ""
    path: str = ""  # group inside interestpoints.n5, e.g. tpId_0_viewSetupId_1/beads


@dataclass
class PairwiseStitchingResult:
    """A pairwise shift between two view groups (SparkPairwiseStitching output).

    ``transform`` is the 3x4 affine mapping group A into group B's space
    (translation-only for phase correlation); ``hash`` ties the result to the
    registrations it was computed against so the solver can reject stale links
    (reference: Spark.java:201-233, SparkPairwiseStitching.java:287-299).
    """

    views_a: tuple[ViewId, ...]
    views_b: tuple[ViewId, ...]
    transform: np.ndarray  # 3x4
    correlation: float
    hash: float = 0.0
    bbox: Interval | None = None

    @property
    def pair_key(self) -> tuple:
        return (self.views_a, self.views_b)


def registration_hash(transforms_a: Sequence[np.ndarray],
                      transforms_b: Sequence[np.ndarray]) -> float:
    """Stable scalar fingerprint of the registrations a stitching result was
    computed under (role of ``PairwiseStitchingResult.getHash()``)."""
    h = 0.0
    for m in list(transforms_a) + list(transforms_b):
        h += float(np.sum(np.asarray(m, dtype=np.float64)
                          * np.arange(1, 13).reshape(3, 4)))
    return h


class SpimData:
    """The project: sequence description + registrations + derived state."""

    def __init__(self):
        self.base_path: str = "."
        self.image_loader: ImageLoader = ImageLoader()
        self.setups: dict[int, ViewSetup] = {}
        # attribute name -> {entity id -> entity}
        self.attributes: dict[str, dict[int, AttributeEntity]] = {
            a: {} for a in VIEW_ATTRIBUTES
        }
        self.timepoints: list[int] = [0]
        self.missing_views: set[ViewId] = set()
        self.registrations: dict[ViewId, list[ViewTransform]] = {}
        self.interest_points: dict[ViewId, dict[str, InterestPointLookup]] = {}
        self.bounding_boxes: dict[str, Interval] = {}
        self.stitching_results: dict[tuple, PairwiseStitchingResult] = {}
        # virtual split views: new setup id -> (source setup id, pixel offset)
        # (role of the reference's SplitViewerImgLoader; models.splitting)
        self.split_info: dict[int, tuple[int, tuple[int, int, int]]] = {}
        self._unknown_sections: list[ET.Element] = []
        self.xml_path: str | None = None  # where this project was loaded from

    # ------------------------------------------------------------------ views

    def view_ids(self, include_missing: bool = False) -> list[ViewId]:
        out = [
            ViewId(t, s)
            for t in self.timepoints
            for s in sorted(self.setups)
        ]
        if not include_missing:
            out = [v for v in out if v not in self.missing_views]
        return out

    def view_size(self, view: ViewId) -> tuple[int, int, int]:
        return self.setups[view.setup].size

    def model(self, view: ViewId) -> np.ndarray:
        """Full pixel->world affine of a view (concatenated chain)."""
        chain = self.registrations.get(view)
        if not chain:
            return identity_affine()
        return concatenate_all([t.affine for t in chain])

    def preconcatenate_transform(self, view: ViewId, t: ViewTransform) -> None:
        """Add a transform applied AFTER everything else (prepend to chain)."""
        self.registrations.setdefault(view, []).insert(0, t)

    def setup_attribute(self, setup_id: int, attr: str) -> int:
        return self.setups[setup_id].attributes.get(attr, 0)

    # ------------------------------------------------------------------- load

    @staticmethod
    def load(path: str | os.PathLike) -> "SpimData":
        """Load a project XML from a local path (``file://`` allowed)."""
        from . import uris

        path = uris.local_path(path)
        root = ET.parse(path).getroot()
        if root.tag != "SpimData":
            raise ValueError(f"not a SpimData XML: root tag {root.tag!r}")
        sd = SpimData()
        sd.xml_path = path

        bp = root.find("BasePath")
        if bp is not None:
            sd.base_path = bp.text or "."

        seq = root.find("SequenceDescription")
        if seq is None:
            raise ValueError("missing SequenceDescription")
        sd._parse_sequence(seq)

        vr = root.find("ViewRegistrations")
        if vr is not None:
            for el in vr.findall("ViewRegistration"):
                vid = ViewId(int(el.get("timepoint")), int(el.get("setup")))
                chain = []
                for t in el.findall("ViewTransform"):
                    name_el = t.find("Name")
                    aff_el = t.find("affine")
                    chain.append(
                        ViewTransform(
                            name_el.text if name_el is not None else "",
                            affine_from_flat(aff_el.text.split()),
                        )
                    )
                sd.registrations[vid] = chain

        vip = root.find("ViewInterestPoints")
        if vip is not None:
            for el in vip.findall("ViewInterestPointsFile"):
                vid = ViewId(int(el.get("timepoint")), int(el.get("setup")))
                label = el.get("label")
                sd.interest_points.setdefault(vid, {})[label] = InterestPointLookup(
                    label=label,
                    params=el.get("params", ""),
                    path=(el.text or "").strip(),
                )

        bbs = root.find("BoundingBoxes")
        if bbs is not None:
            for el in bbs.findall("BoundingBoxDefinition"):
                mn = [int(v) for v in el.find("min").text.split()]
                mx = [int(v) for v in el.find("max").text.split()]
                sd.bounding_boxes[el.get("name")] = Interval(mn, mx)

        sr = root.find("StitchingResults")
        if sr is not None:
            for el in sr.findall("PairwiseResult"):
                res = _parse_pairwise_result(el)
                sd.stitching_results[res.pair_key] = res

        si = root.find("SplitInfo")
        if si is not None:
            for el in si.findall("Split"):
                sd.split_info[int(el.get("setup"))] = (
                    int(el.get("source")),
                    tuple(int(v) for v in el.get("offset").split()),
                )

        known = {
            "BasePath", "SequenceDescription", "ViewRegistrations",
            "ViewInterestPoints", "BoundingBoxes", "StitchingResults",
            "SplitInfo",
        }
        for child in root:
            if child.tag not in known:
                sd._unknown_sections.append(copy.deepcopy(child))
        return sd

    def _parse_sequence(self, seq: ET.Element) -> None:
        il = seq.find("ImageLoader")
        if il is not None:
            fmt = il.get("format", "")
            loader = ImageLoader(format=fmt, raw=copy.deepcopy(il))
            for tag in ("n5", "zarr", "hdf5", "ome.zarr"):
                sub = il.find(tag)
                if sub is not None:
                    loader.path = (sub.text or "").strip()
                    loader.path_type = sub.get("type", "relative")
                    break
            self.image_loader = loader

        vss = seq.find("ViewSetups")
        if vss is not None:
            for el in vss.findall("ViewSetup"):
                vs = ViewSetup(
                    id=int(el.findtext("id")),
                    name=el.findtext("name", default=""),
                    size=tuple(int(v) for v in el.findtext("size", default="0 0 0").split()),
                )
                vox = el.find("voxelSize")
                if vox is not None:
                    vs.voxel_unit = vox.findtext("unit", default="um")
                    vs.voxel_size = tuple(
                        float(v) for v in vox.findtext("size", default="1 1 1").split()
                    )
                attrs = el.find("attributes")
                if attrs is not None:
                    for a in attrs:
                        vs.attributes[a.tag] = int(a.text)
                self.setups[vs.id] = vs
            for el in vss.findall("Attributes"):
                name = el.get("name")
                table = self.attributes.setdefault(name, {})
                for ent in el:
                    eid = int(ent.findtext("id"))
                    ename = ent.findtext("name", default=str(eid))
                    extra = {}
                    for sub in ent:
                        if sub.tag not in ("id", "name"):
                            extra[sub.tag] = sub.text
                    table[eid] = AttributeEntity(eid, ename, extra)

        tps = seq.find("Timepoints")
        if tps is not None:
            ttype = tps.get("type", "pattern")
            if ttype == "pattern":
                self.timepoints = _parse_integer_pattern(
                    tps.findtext("integerpattern", default="0")
                )
            elif ttype == "range":
                first = int(tps.findtext("first", default="0"))
                last = int(tps.findtext("last", default="0"))
                self.timepoints = list(range(first, last + 1))
            else:
                raise ValueError(f"unsupported Timepoints type {ttype!r}")

        mv = seq.find("MissingViews")
        if mv is not None:
            for el in mv.findall("MissingView"):
                self.missing_views.add(
                    ViewId(int(el.get("timepoint")), int(el.get("setup")))
                )

    # ------------------------------------------------------------------- save

    def save(self, path: str | os.PathLike | None = None) -> None:
        if path is None:
            path = self.xml_path
        if path is None:
            raise ValueError("no path to save to")
        path = str(path)
        root = ET.Element("SpimData", version="0.2")
        bp = ET.SubElement(root, "BasePath", type="relative")
        bp.text = self.base_path

        seq = ET.SubElement(root, "SequenceDescription")
        self._write_sequence(seq)

        vr = ET.SubElement(root, "ViewRegistrations")
        for vid in sorted(self.registrations):
            el = ET.SubElement(
                vr, "ViewRegistration",
                timepoint=str(vid.timepoint), setup=str(vid.setup),
            )
            for t in self.registrations[vid]:
                tel = ET.SubElement(el, "ViewTransform", type="affine")
                ET.SubElement(tel, "Name").text = t.name
                ET.SubElement(tel, "affine").text = " ".join(
                    repr(v) for v in affine_to_flat(t.affine)
                )

        vip = ET.SubElement(root, "ViewInterestPoints")
        for vid in sorted(self.interest_points):
            for label, lk in sorted(self.interest_points[vid].items()):
                el = ET.SubElement(
                    vip, "ViewInterestPointsFile",
                    timepoint=str(vid.timepoint), setup=str(vid.setup),
                    label=label, params=lk.params,
                )
                el.text = lk.path

        bbs = ET.SubElement(root, "BoundingBoxes")
        for name, box in sorted(self.bounding_boxes.items()):
            el = ET.SubElement(bbs, "BoundingBoxDefinition", name=name)
            ET.SubElement(el, "min").text = " ".join(str(v) for v in box.min)
            ET.SubElement(el, "max").text = " ".join(str(v) for v in box.max)

        preserved = {el.tag: el for el in self._unknown_sections}
        root.append(copy.deepcopy(preserved.pop(
            "PointSpreadFunctions", ET.Element("PointSpreadFunctions"))))

        sr = ET.SubElement(root, "StitchingResults")
        for res in self.stitching_results.values():
            sr.append(_pairwise_result_to_xml(res))

        root.append(copy.deepcopy(preserved.pop(
            "IntensityAdjustments", ET.Element("IntensityAdjustments"))))

        if self.split_info:
            si = ET.SubElement(root, "SplitInfo")
            for setup, (src, off) in sorted(self.split_info.items()):
                ET.SubElement(si, "Split", setup=str(setup), source=str(src),
                              offset=" ".join(str(v) for v in off))

        for el in preserved.values():
            root.append(copy.deepcopy(el))

        ET.indent(root)
        from . import uris

        path = uris.local_path(path)
        ET.ElementTree(root).write(path, encoding="unicode",
                                   xml_declaration=True)
        self.xml_path = path

    def _write_sequence(self, seq: ET.Element) -> None:
        il = self.image_loader
        known = {"bdv.n5", "bdv.zarr", "bdv.hdf5"}
        if il.raw is not None and il.format not in known:
            seq.append(copy.deepcopy(il.raw))
        else:
            el = ET.SubElement(seq, "ImageLoader", format=il.format, version="1.0")
            tag = {"bdv.n5": "n5", "bdv.zarr": "zarr", "bdv.hdf5": "hdf5"}.get(
                il.format, "n5"
            )
            sub = ET.SubElement(el, tag, type=il.path_type)
            sub.text = il.path

        vss = ET.SubElement(seq, "ViewSetups")
        for sid in sorted(self.setups):
            vs = self.setups[sid]
            el = ET.SubElement(vss, "ViewSetup")
            ET.SubElement(el, "id").text = str(vs.id)
            ET.SubElement(el, "name").text = vs.name or str(vs.id)
            ET.SubElement(el, "size").text = " ".join(str(v) for v in vs.size)
            vox = ET.SubElement(el, "voxelSize")
            ET.SubElement(vox, "unit").text = vs.voxel_unit
            ET.SubElement(vox, "size").text = " ".join(repr(float(v)) for v in vs.voxel_size)
            attrs = ET.SubElement(el, "attributes")
            attr_names = list(VIEW_ATTRIBUTES) + [
                a for a in vs.attributes if a not in VIEW_ATTRIBUTES
            ]
            for a in attr_names:
                ET.SubElement(attrs, a).text = str(vs.attributes.get(a, 0))
        all_tables = list(VIEW_ATTRIBUTES) + [
            n for n in self.attributes if n not in VIEW_ATTRIBUTES
        ]
        for name in all_tables:
            table = self.attributes.get(name, {})
            el = ET.SubElement(vss, "Attributes", name=name)
            for eid in sorted(table):
                ent = table[eid]
                tag = _ATTR_TAG.get(name, name.capitalize())
                sub = ET.SubElement(el, tag)
                ET.SubElement(sub, "id").text = str(ent.id)
                ET.SubElement(sub, "name").text = ent.name
                for k, v in ent.extra.items():
                    ET.SubElement(sub, k).text = v

        tps = ET.SubElement(seq, "Timepoints", type="pattern")
        ET.SubElement(tps, "integerpattern").text = _format_integer_pattern(self.timepoints)

        mv = ET.SubElement(seq, "MissingViews")
        for vid in sorted(self.missing_views):
            ET.SubElement(
                mv, "MissingView",
                timepoint=str(vid.timepoint), setup=str(vid.setup),
            )

    # ---------------------------------------------------------------- helpers

    def resolve_loader_path(self) -> str:
        from . import uris

        lp = self.image_loader.path
        if (self.image_loader.path_type == "absolute" or os.path.isabs(lp)
                or uris.has_scheme(lp)):
            return uris.local_path(lp)
        base = uris.dirname(self.xml_path or ".")
        return uris.normpath(uris.join(base, self.base_path, lp))


def _parse_integer_pattern(pattern: str) -> list[int]:
    out: list[int] = []
    for part in pattern.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part[1:]:
            a, rest = part.split("-", 1)
            step = 1
            if ":" in rest:  # spim_data TimePointsPattern "a-b:step"
                rest, s = rest.split(":", 1)
                step = int(s)
            out.extend(range(int(a), int(rest) + 1, step))
        else:
            out.append(int(part))
    return sorted(set(out)) or [0]


def _format_integer_pattern(tps: list[int]) -> str:
    tps = sorted(set(tps))
    if len(tps) > 1 and tps == list(range(tps[0], tps[-1] + 1)):
        return f"{tps[0]}-{tps[-1]}"
    return ",".join(str(t) for t in tps)


def _views_attr(views: Iterable[ViewId]) -> str:
    return ";".join(f"{v.timepoint},{v.setup}" for v in views)


def _parse_views_attr(s: str) -> tuple[ViewId, ...]:
    return tuple(
        ViewId(int(a), int(b))
        for a, b in (p.split(",") for p in s.split(";") if p)
    )


def _pairwise_result_to_xml(res: PairwiseStitchingResult) -> ET.Element:
    el = ET.Element(
        "PairwiseResult",
        views_a=_views_attr(res.views_a),
        views_b=_views_attr(res.views_b),
        hash=repr(res.hash),
    )
    ET.SubElement(el, "shift").text = " ".join(repr(v) for v in affine_to_flat(res.transform))
    ET.SubElement(el, "correlation").text = repr(float(res.correlation))
    if res.bbox is not None:
        ET.SubElement(el, "bbox_min").text = " ".join(str(v) for v in res.bbox.min)
        ET.SubElement(el, "bbox_max").text = " ".join(str(v) for v in res.bbox.max)
    return el


def _parse_pairwise_result(el: ET.Element) -> PairwiseStitchingResult:
    bbox = None
    if el.find("bbox_min") is not None:
        bbox = Interval(
            [int(v) for v in el.findtext("bbox_min").split()],
            [int(v) for v in el.findtext("bbox_max").split()],
        )
    return PairwiseStitchingResult(
        views_a=_parse_views_attr(el.get("views_a")),
        views_b=_parse_views_attr(el.get("views_b")),
        transform=affine_from_flat(el.findtext("shift").split()),
        correlation=float(el.findtext("correlation", default="0")),
        hash=float(el.get("hash", "0")),
        bbox=bbox,
    )
