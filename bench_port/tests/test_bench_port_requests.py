"""A cell's ``request`` reaches ``SearchRequest`` whole: enums by name,
facet, filter, sort and highlight objects from dicts, and a key that names
no field raises; today's cells give the requests they gave before."""

import pytest

import seekstorm_tpu_torch as st
from conftest import tiny
from harness import files
from harness.requests import search_requests


def _parent_requests(cell: dict, base: list[dict]) -> list:
    """The seven keys the harness passed on before (its ``_requests``)."""
    r = dict(cell["request"])
    kw = dict(length=int(r.get("length", 10)),
              realtime=bool(r.get("realtime", True)),
              result_type=st.ResultType[r.get("result_type", "TopkCount")])
    for key in ("ann_mode", "nprobe", "top_n"):
        if key in r:
            kw[key] = r[key]
    if "search_mode" in r:
        kw["search_mode"] = st.SearchMode[r["search_mode"]]
    return [st.SearchRequest(**kw, **b) for b in base]


@pytest.mark.parametrize("name", ["wiki1m.topkcount_b512",
                                  "sift1m.nprobe16_b64"])
def test_todays_cells_give_the_requests_they_gave_before(name):
    cell, config = tiny(name)
    kind = files.load_kind(config["kind"])
    system = kind.System(config, cell, 2**31 + 5)
    got = system.requests(st)
    if config["kind"] == "text":
        base = [dict(query=q, query_type_default=st.QueryType[t])
                for q, t in system.pool]
    else:
        base = [dict(query_vector=v.tolist()) for v in system.pool]
    assert got == _parent_requests(cell, base)


def test_every_field_and_nested_object_is_built():
    cell = {"request": {
        "result_type": "Count", "realtime": False, "offset": 20,
        "length": 5, "search_mode": "Hybrid", "similarity_threshold": 1,
        "fields": ["title"], "field_filter": ["body"],
        "query_facets": [{"field": "brand", "length": 20},
                         {"field": "price", "ranges": {
                             "field": "price",
                             "ranges": [["cheap", 0], ["dear", 100]]}}],
        "facet_filter": [{"field": "brand", "values": ["acme"]},
                         {"field": "price", "range": [10, 50]}],
        "result_sort": [{"field": "price", "order": "Ascending"}],
        "highlights": [{"field": "body", "fragment_size": 80}]}}
    (r,) = search_requests(st, cell, [dict(query="w00021",
                                           query_type_default="Phrase")])
    assert r.result_type is st.ResultType.Count
    assert r.search_mode is st.SearchMode.Hybrid
    assert r.query_type_default is st.QueryType.Phrase
    assert (r.realtime, r.offset, r.length) == (False, 20, 5)
    assert r.similarity_threshold == 1.0 and isinstance(
        r.similarity_threshold, float)
    assert r.query_facets == [
        st.QueryFacet("brand", 20),
        st.QueryFacet("price", ranges=st.Ranges(
            "price", [["cheap", 0], ["dear", 100]]))]
    assert r.facet_filter == [st.FacetFilter("brand", values=["acme"]),
                              st.FacetFilter("price", range=(10, 50))]
    assert r.result_sort == [st.ResultSort("price", "Ascending")]
    assert r.highlights == [st.Highlight("body", fragment_size=80)]
    assert (r.fields, r.field_filter) == (["title"], ["body"])


@pytest.mark.parametrize("request_, where", [
    ({"realtme": True}, "'realtme'"),
    ({"query_facets": [{"field": "brand", "lenght": 3}]}, "'lenght'"),
    ({"result_sort": [{"field": "price", "base": None, "way": 1}]}, "'way'"),
    ({"query_facets": [{"field": "p", "ranges": {"field": "p", "ranges": [],
                                                  "kind": 1}}]}, "'kind'"),
])
def test_an_unknown_key_raises_and_names_it(request_, where):
    with pytest.raises(ValueError, match=f"has no field {where}"):
        search_requests(st, {"request": request_}, [dict(query="w00021")])


@pytest.mark.parametrize("request_, error", [
    ({"result_type": "TopKCount"}, ValueError),
    ({"realtime": "false"}, TypeError),
    ({"length": 10.0}, TypeError),
    ({"facet_filter": {"field": "brand"}}, TypeError),
    ({"query_facets": ["brand"]}, TypeError),
])
def test_a_value_of_the_wrong_kind_raises(request_, error):
    with pytest.raises(error):
        search_requests(st, {"request": request_}, [dict(query="w00021")])

