"""Embedded web UI: instant search with facets, range/date histogram
sliders, document preview, sorting and paging (own implementation of the
reference's embedded UI capability — facet histogram slider + date
filter + PDF preview, reference seekstorm_server/web/js/master.js:14,19 —
served at GET /).  The preview modal shows the stored document (for PDFs
ingested via /file, that is the extracted text)."""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>seekstorm-tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
  :root { --fg:#1a1d21; --mut:#6b7280; --line:#e5e7eb; --acc:#2563eb; }
  * { box-sizing: border-box; }
  body { margin:0; font:15px/1.5 system-ui, sans-serif; color:var(--fg); }
  header { display:flex; gap:.75rem; align-items:center; padding:.8rem 1.2rem;
           border-bottom:1px solid var(--line); flex-wrap:wrap; }
  header h1 { font-size:1.05rem; margin:0 1rem 0 0; }
  input, select { font:inherit; padding:.45rem .6rem; border:1px solid var(--line);
           border-radius:6px; }
  #q { flex:1; min-width:16rem; }
  main { display:flex; gap:2rem; padding:1.2rem; max-width:70rem; margin:auto; }
  #facets { width:15rem; flex:none; }
  #facets h3 { font-size:.8rem; text-transform:uppercase; color:var(--mut);
               margin:.8rem 0 .3rem; }
  #facets label { display:flex; justify-content:space-between; cursor:pointer; }
  #facets .cnt { color:var(--mut); }
  #results { flex:1; }
  .hit { padding:.7rem 0; border-bottom:1px solid var(--line); }
  .hit .id { color:var(--mut); font-size:.8rem; }
  .hit b { background:#fde68a; font-weight:600; }
  #stats { color:var(--mut); font-size:.85rem; margin-bottom:.6rem; }
  #sugg { color:var(--acc); font-size:.85rem; }
  button { font:inherit; padding:.4rem .8rem; border:1px solid var(--line);
           background:#fff; border-radius:6px; cursor:pointer; }
  .rng { margin:.2rem 0 .6rem; }
  .rng .bars { display:flex; align-items:flex-end; gap:1px; height:2.2rem; }
  .rng .bars div { flex:1; background:var(--acc); opacity:.35; min-height:1px; }
  .rng .bars div.on { opacity:.9; }
  .rng input[type=range] { width:100%; margin:0; }
  .rng .lbl { display:flex; justify-content:space-between; color:var(--mut);
              font-size:.75rem; }
  #modal { position:fixed; inset:0; background:rgba(0,0,0,.45);
           display:none; align-items:center; justify-content:center; }
  #modal .card { background:#fff; max-width:46rem; max-height:80vh;
                 overflow:auto; padding:1.2rem; border-radius:10px;
                 white-space:pre-wrap; }
  .hit .preview { color:var(--acc); cursor:pointer; font-size:.8rem; }
</style>
</head>
<body>
<header>
  <h1>seekstorm-tpu</h1>
  <input id="apikey" placeholder="apikey" size="18">
  <input id="index" placeholder="index id" size="6" value="0">
  <select id="mode">
    <option value="Lexical">lexical</option>
    <option value="Hybrid">hybrid</option>
  </select>
  <select id="qtype">
    <option value="Intersection">AND</option>
    <option value="Union">OR</option>
  </select>
  <input id="q" placeholder="search…" autofocus>
</header>
<div id="modal"><div class="card"></div></div>
<main>
  <aside id="facets"></aside>
  <section id="results">
    <div id="stats"></div>
    <div id="sugg"></div>
    <div id="hits"></div>
    <p><button id="more" hidden>more</button></p>
  </section>
</main>
<script>
const $ = s => document.querySelector(s);
let offset = 0, facetFields = [], activeFilters = {}, schema = [];
let rangeFields = {}, activeRanges = {};  // numeric/date facet sliders
const NBUCKETS = 20;
const isDate = f => f.field_type === "Timestamp";
function fmtVal(f, v) {
  return isDate(f) ? new Date(v * 1000).toISOString().slice(0, 10)
                   : (+v).toLocaleString();
}
for (const k of ["apikey","index"]) {
  $("#"+k).value = localStorage.getItem("st_"+k) || $("#"+k).value;
  $("#"+k).addEventListener("change", e => {
    localStorage.setItem("st_"+k, e.target.value); loadSchema().then(search);
  });
}
async function api(path, body, method="POST") {
  const r = await fetch(`/api/v1/index/${$("#index").value}${path}`, {
    method, headers: {apikey: $("#apikey").value,
                      "Content-Type": "application/json"},
    body: body ? JSON.stringify(body) : undefined});
  if (!r.ok) throw new Error((await r.json()).error || r.status);
  return r.json();
}
async function loadSchema() {
  try {
    const info = await api("", null, "GET");
    schema = info.schema || [];
    rangeFields = info.facets_minmax || {};
    facetFields = schema.filter(f => f.facet && !(f.field in rangeFields))
                        .map(f => f.field);
    $("#stats").textContent =
      `${info.indexed_doc_count} docs · ${info.term_count} terms`;
  } catch (e) { $("#stats").textContent = e.message; }
}
function bucketBounds(field) {
  const [lo, hi] = rangeFields[field];
  const w = (hi - lo) / NBUCKETS || 1;
  return Array.from({length: NBUCKETS}, (_, i) => lo + i * w);
}
function req(extraLen) {
  const filters = Object.entries(activeFilters)
    .filter(([_, vs]) => vs.size)
    .map(([f, vs]) => ({field: f, values: [...vs]}));
  for (const [f, r] of Object.entries(activeRanges))
    if (r) filters.push({field: f, range: r});
  // histogram facets for numeric/date fields (reference master.js:14
  // facet histogram slider + date filter)
  const rangeFacets = Object.keys(rangeFields).map(f => ({
    field: f, length: NBUCKETS,
    ranges: {field: f, range_type: "CountWithinRange",
             ranges: bucketBounds(f).map((b, i) => [String(i), b])},
  }));
  return {
    query: $("#q").value, offset, length: 10 + (extraLen||0),
    realtime: true, query_type_default: $("#qtype").value,
    search_mode: $("#mode").value,
    highlights: schema.filter(f => f.store && f.field_type === "Text")
                      .map(f => ({field: f.field, fragment_size: 200})),
    query_facets: [...facetFields.map(f => ({field: f, length: 8})),
                   ...rangeFacets],
    facet_filter: filters,
  };
}
async function preview(id) {
  const doc = await api(`/doc/${id}`, null, "GET");
  const card = $("#modal .card");
  card.textContent = Object.entries(doc)
    .map(([k, v]) => `${k}:\n${v}`).join("\n\n");
  $("#modal").style.display = "flex";
}
$("#modal").onclick = () => $("#modal").style.display = "none";
function render(r, append) {
  if (!append) $("#hits").innerHTML = "";
  $("#stats").textContent =
    `${r.count_total} results · ${(r.time/1e6).toFixed(2)} ms`;
  $("#sugg").textContent = r.suggestions?.length
    ? "suggestions: " + r.suggestions.join(", ") : "";
  for (const hit of r.results) {
    const div = document.createElement("div");
    div.className = "hit";
    const hl = hit._highlights || {};
    let body = "";
    for (const f of schema.filter(f => f.store)) {
      const v = hl[f.field] ?? hit[f.field];
      if (typeof v === "string" && v) body += `<div>${v}</div>`;
    }
    div.innerHTML = `<div class="id">#${hit._id} · ${
      hit._score.toFixed(3)} <span class="preview">preview</span></div>${body}`;
    div.querySelector(".preview").onclick = () => preview(hit._id);
    $("#hits").appendChild(div);
  }
  $("#more").hidden = r.results.length < 10;
  const side = $("#facets"); side.innerHTML = "";
  // range/date histogram sliders
  for (const field of Object.keys(rangeFields)) {
    const vals = (r.facets || {})[field];
    if (!vals) continue;
    const f = schema.find(x => x.field === field) || {};
    const h = document.createElement("h3"); h.textContent = field;
    side.appendChild(h);
    const box = document.createElement("div"); box.className = "rng";
    const bounds = bucketBounds(field);
    const counts = new Array(NBUCKETS).fill(0);
    for (const [lbl, cnt] of vals) counts[+lbl] = cnt;
    const mx = Math.max(...counts, 1);
    const bars = document.createElement("div"); bars.className = "bars";
    const cur = activeRanges[field];
    counts.forEach((c, i) => {
      const bar = document.createElement("div");
      bar.style.height = `${Math.round(c / mx * 100)}%`;
      const bLo = bounds[i], bHi = bounds[i + 1] ?? rangeFields[field][1];
      if (!cur || (bHi >= cur[0] && bLo <= cur[1])) bar.className = "on";
      bars.appendChild(bar);
    });
    box.appendChild(bars);
    const [lo, hi] = rangeFields[field];
    const mkSlider = (val) => {
      const sl = document.createElement("input");
      sl.type = "range"; sl.min = lo; sl.max = hi;
      sl.step = (hi - lo) / 100 || 1; sl.value = val;
      return sl;
    };
    const s1 = mkSlider(cur ? cur[0] : lo);
    const s2 = mkSlider(cur ? cur[1] : hi);
    const lblRow = document.createElement("div"); lblRow.className = "lbl";
    const upd = () => {
      const a = Math.min(+s1.value, +s2.value);
      const b = Math.max(+s1.value, +s2.value);
      lblRow.textContent = "";
      const l1 = document.createElement("span");
      l1.textContent = fmtVal(f, a);
      const l2 = document.createElement("span");
      l2.textContent = fmtVal(f, b);
      lblRow.append(l1, l2);
      return [a, b];
    };
    upd();
    const apply = () => {
      const [a, b] = upd();
      activeRanges[field] = (a <= lo && b >= hi) ? null : [a, b];
      offset = 0; search();
    };
    s1.oninput = upd; s2.oninput = upd;
    s1.onchange = apply; s2.onchange = apply;
    box.append(s1, s2, lblRow);
    side.appendChild(box);
  }
  for (const [field, vals] of Object.entries(r.facets || {})) {
    if (field in rangeFields) continue;
    const h = document.createElement("h3"); h.textContent = field;
    side.appendChild(h);
    for (const [val, cnt] of vals) {
      const lab = document.createElement("label");
      const cb = document.createElement("input");
      cb.type = "checkbox";
      cb.checked = activeFilters[field]?.has(val);
      cb.onchange = () => {
        activeFilters[field] = activeFilters[field] || new Set();
        cb.checked ? activeFilters[field].add(val)
                   : activeFilters[field].delete(val);
        offset = 0; search();
      };
      lab.append(cb, ` ${val} `);
      const c = document.createElement("span");
      c.className = "cnt"; c.textContent = cnt;
      lab.appendChild(c);
      side.appendChild(lab);
    }
  }
}
let timer;
async function search(append) {
  try { render(await api("/query", req()), append); }
  catch (e) { $("#stats").textContent = e.message; }
}
$("#q").addEventListener("input", () => {
  offset = 0; clearTimeout(timer); timer = setTimeout(() => search(), 150);
});
for (const id of ["mode","qtype"])
  $("#"+id).addEventListener("change", () => { offset = 0; search(); });
$("#more").onclick = () => { offset += 10; search(true); };
loadSchema();
</script>
</body>
</html>
"""
