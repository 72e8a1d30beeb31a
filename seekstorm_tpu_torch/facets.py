"""Facet runtime: columnar facet codes, filters, sort keys, index-level
aggregations.

The port's copy of ``seekstorm_tpu/facets.py`` (numpy only).  What differs:
the runtime is kept per index state (``get_runtime`` keys it on
``ops/wand._signature``, as the port's device state is, and on the shards'
doc counts, since an uncommitted doc can bring a new facet value and with it
a label) where the reference marks it dirty on every ingest, commit and
delete.

Mirrors the reference's facet machinery (reference seekstorm/src/
search.rs:220-1020 QueryFacet/FacetFilter/ResultSort types,
add_result.rs:341 is_facet_filter, :487 facet_count, index.rs:4649/4845
index-level facets) with a columnar TPU formulation:

* every facet field is a fixed-width column per shard (built at commit);
* facet counting is a per-block scatter-add over a small code space —
  string facets count ordinals, numeric range facets count searchsorted
  bucket codes (precomputed host-side per Ranges spec and cached);
* facet filters compile to boolean doc masks merged into the delete mask;
* result sorting uses a per-doc f32 sort-key column (facet value, or geo
  distance from a Point column + base point).
"""

from __future__ import annotations

import numpy as np

from . import geo
from .schema import BLOCK_SIZE, FieldType, SchemaField
from .utils import ceil_pow2


def _stacked_columns(index, sf: SchemaField) -> np.ndarray:
    """Facet column stacked over shards, padded to [S, NB_pad*BLOCK]."""
    S = index.shard_count
    nb = max(max(sh.lexical.n_blocks for sh in index.shards), 1)
    out = np.zeros((S, nb * BLOCK_SIZE), dtype=np.float64)
    raw = np.zeros((S, nb * BLOCK_SIZE), dtype=np.uint64)
    for s, sh in enumerate(index.shards):
        col = sh.facet_cols.get(sf.facet_id)
        if col is None:
            continue
        # columns are per-level concatenated over committed docs; re-expand
        # to block-aligned addressing
        pos = 0
        for li, lvl in enumerate(sh.lexical.levels):
            n = lvl.doc_count
            seg = col[pos : pos + n]
            if sf.field_type == FieldType.Point:
                raw[s, li * BLOCK_SIZE : li * BLOCK_SIZE + n] = seg
            else:
                out[s, li * BLOCK_SIZE : li * BLOCK_SIZE + n] = seg
            pos += n
    if sf.field_type == FieldType.Point:
        return raw
    return out


class FacetRuntime:
    """Per-index cache of stacked facet columns / codes / masks / keys."""

    def __init__(self, index):
        self.index = index
        self._cols: dict[int, np.ndarray] = {}
        self._codes: dict = {}
        self._masks: dict = {}
        self._keys: dict = {}

    def invalidate(self):
        self._cols.clear()
        self._codes.clear()
        self._masks.clear()
        self._keys.clear()

    def field(self, name: str) -> SchemaField:
        sf = self.index.schema_map.get(name)
        if sf is None or not sf.facet:
            raise ValueError(f"{name!r} is not a facet field")
        return sf

    def column(self, sf: SchemaField) -> np.ndarray:
        if sf.facet_id not in self._cols:
            self._cols[sf.facet_id] = _stacked_columns(self.index, sf)
        return self._cols[sf.facet_id]

    # -- counting codes ------------------------------------------------
    def codes_for(self, qf) -> tuple[np.ndarray, list, int]:
        """QueryFacet -> (codes [S, N] i32, labels, n_codes)."""
        ranges_sig = (
            tuple((r[0], float(r[1])) for r in qf.ranges.ranges)
            if qf.ranges
            else None
        )
        key = (qf.field, ranges_sig)
        if key in self._codes:
            return self._codes[key]
        sf = self.field(qf.field)
        col = self.column(sf)
        if qf.ranges is not None:
            if sf.field_type == FieldType.Point:
                # distance buckets from a base point (reference Ranges::Point)
                if qf.ranges.base is None:
                    raise ValueError("Point ranges require a base point")
                dcol = geo.point_distance(
                    col, float(qf.ranges.base[0]), float(qf.ranges.base[1])
                )
                if qf.ranges.unit == "Miles":
                    dcol = dcol * 0.621371192
                col = dcol
            bounds = np.array([float(r[1]) for r in qf.ranges.ranges])
            labels = [r[0] for r in qf.ranges.ranges]
            # bucket 0 = below first bound; bucket i = [bounds[i-1], bounds[i])
            codes = np.searchsorted(bounds, col, side="right").astype(np.int32)
            labels = ["_below"] + labels
            n_codes = len(labels)
        elif sf.field_type in (FieldType.StringSet16, FieldType.StringSet32):
            # codes are SET ordinals; expansion to per-value counts happens
            # at result assembly (reference string_set_to_single_term_id)
            codes = col.astype(np.int32)
            sets = getattr(self.index, "_facet_set_tables", {}).get(
                sf.facet_id, {(): 0}
            )
            tab = getattr(self.index, "_facet_tables", {}).get(
                sf.facet_id, {"": 0}
            )
            rev = {v: k for k, v in tab.items()}
            set_members = [()] * len(sets)
            for members, so in sets.items():
                if so < len(set_members):
                    set_members[so] = tuple(rev.get(m, str(m)) for m in members)
            labels = ("__SETS__", set_members)
            n_codes = max(len(sets), 1)
        elif sf.field_type.is_string_facet:
            codes = col.astype(np.int32)
            tab = getattr(self.index, "_facet_tables", {}).get(sf.facet_id, {"": 0})
            rev = [""] * len(tab)
            for k2, v in tab.items():
                if v < len(rev):
                    rev[v] = k2
            labels = rev
            n_codes = max(len(rev), 1)
        else:
            # numeric facet without ranges: count distinct small-int values
            codes = col.astype(np.int32)
            mx = int(codes.max()) if codes.size else 0
            if mx > 65_535:
                raise ValueError(
                    f"facet {qf.field}: numeric facet counting without ranges "
                    f"requires values <= 65535 (max={mx}); pass Ranges"
                )
            labels = None  # labels are the values themselves
            n_codes = mx + 1
        out = (codes, labels, n_codes)
        self._codes[key] = out
        return out

    # -- filters -------------------------------------------------------
    def filter_mask(self, filters) -> np.ndarray | None:
        """FacetFilter list -> allowed bool [S, N] (None = no filtering)."""
        if not filters:
            return None
        sig = tuple(
            (f.field, tuple(f.values) if f.values else None,
             tuple(f.range) if f.range else None)
            for f in filters
        )
        if sig in self._masks:
            return self._masks[sig]
        allowed = None
        for f in filters:
            sf = self.field(f.field)
            col = self.column(sf)
            if f.values is not None:
                if sf.field_type in (FieldType.StringSet16,
                                     FieldType.StringSet32):
                    # allowed set ordinals = sets containing any given value
                    tab = getattr(self.index, "_facet_tables", {}).get(
                        sf.facet_id, {"": 0}
                    )
                    want = {tab.get(str(v), -1) for v in f.values}
                    sets = getattr(self.index, "_facet_set_tables", {}).get(
                        sf.facet_id, {(): 0}
                    )
                    vals = [so for members, so in sets.items()
                            if want & set(members)]
                elif sf.field_type.is_string_facet:
                    tab = getattr(self.index, "_facet_tables", {}).get(
                        sf.facet_id, {"": 0}
                    )
                    vals = [tab.get(str(v), -1) for v in f.values]
                else:
                    vals = [float(v) for v in f.values]
                m = np.isin(col, vals)
            elif f.range is not None:
                lo, hi = f.range
                m = (col >= lo) & (col <= hi)
            else:
                continue
            allowed = m if allowed is None else (allowed & m)
        self._masks[sig] = allowed
        return allowed

    # -- sort keys -----------------------------------------------------
    def sort_key(self, rs) -> np.ndarray:
        """ResultSort -> f32 key column [S, N] (larger = later in Ascending)."""
        base_sig = tuple(rs.base) if rs.base is not None else None
        key = (rs.field, base_sig)
        if key in self._keys:
            return self._keys[key]
        sf = self.field(rs.field)
        col = self.column(sf)
        if sf.field_type == FieldType.Point:
            if rs.base is None:
                raise ValueError("Point sort requires a base point")
            lat, lon = float(rs.base[0]), float(rs.base[1])
            out = geo.point_distance(col, lat, lon).astype(np.float32)
        else:
            out = col.astype(np.float32)
        self._keys[key] = out
        return out

    def raw_value(self, field: str, global_id: int):
        """Exact facet value of one doc (for tie-breaking / distance fields)."""
        sf = self.field(field)
        idx = self.index
        shard = idx.shards[global_id % idx.shard_count]
        local = global_id // idx.shard_count
        col = self.column(sf)
        if local >= col.shape[1]:
            return None  # uncommitted tail
        return col[shard.shard_id, local]


def get_runtime(index) -> FacetRuntime:
    """The index's FacetRuntime, rebuilt after an ingest, commit or
    delete; concurrent first callers build it once."""
    from .ops.wand import _signature, index_lock

    sig = (_signature(index), tuple(sh.doc_count for sh in index.shards))
    with index_lock(index, "_torch_facet_lock"):
        hit = index.__dict__.get("_torch_facet_runtime")
        if hit is None or hit[0] != sig:
            hit = index.__dict__["_torch_facet_runtime"] = (
                sig, FacetRuntime(index))
    return hit[1]


# -- index-level facets (reference index.rs:4845, :4649) -----------------

def index_string_facets(index, field: str, length: int = 100):
    rt = get_runtime(index)
    sf = rt.field(field)
    counts: dict[str, int] = {}
    tab = getattr(index, "_facet_tables", {}).get(sf.facet_id, {"": 0})
    rev = {v: k for k, v in tab.items()}
    for s, sh in enumerate(index.shards):
        col = sh.facet_cols.get(sf.facet_id)
        if col is None:
            continue
        vals, cnts = np.unique(col, return_counts=True)
        for v, c in zip(vals, cnts):
            lbl = rev.get(int(v), str(v))
            counts[lbl] = counts.get(lbl, 0) + int(c)
        # uncommitted tail
        start = sh.partial_on_disk
        for v in sh.level0.facet_values.get(sf.facet_id, [])[start:]:
            if v is not None:
                lbl = rev.get(int(v), str(v))
                counts[lbl] = counts.get(lbl, 0) + 1
    top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:length]
    return top


def index_facets_minmax(index, field: str):
    rt = get_runtime(index)
    sf = rt.field(field)
    lo, hi = None, None
    for sh in index.shards:
        col = sh.facet_cols.get(sf.facet_id)
        if col is not None and len(col):
            lo = min(lo, col.min()) if lo is not None else col.min()
            hi = max(hi, col.max()) if hi is not None else col.max()
    return (lo, hi)
