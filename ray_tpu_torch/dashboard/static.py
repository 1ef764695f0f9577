"""Single-file dashboard UI served at ``/``.

The reference ships a 21.5k-line React/TS frontend
(reference: python/ray/dashboard/client/); this is the dependency-free
equivalent for the same data: one HTML page that polls the head's JSON
API (/api/cluster_status, /api/nodes, /api/actors, /api/jobs,
/api/placement_groups, /api/tasks) and renders live tables — cluster
overview, nodes, actors, jobs, placement groups, recent task events —
plus two canvas views the reference renders in React:

  * a task TIMELINE (one lane per worker, spans from each record's
    state_ts transitions — the dashboard-embedded flavor of `python -m ray_tpu_torch
    timeline`'s Chrome-trace export);
  * per-node CPU utilization SPARKLINES + a cluster utilization strip,
    built client-side from the poll history (the reference's
    Grafana-backed metrics charts, without Grafana).

The port's copy of ``ray_tpu/dashboard/static.py``; the resource cards
count GPUs.
"""

PAGE = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>ray_tpu_torch dashboard</title>
<style>
  body { font-family: -apple-system, "Segoe UI", Roboto, sans-serif;
         margin: 0; background: #f7f7f9; color: #1a1a2e; }
  header { background: #1a1a2e; color: #fff; padding: 10px 24px;
           display: flex; align-items: baseline; gap: 16px; }
  header h1 { font-size: 18px; margin: 0; }
  header .sub { color: #9aa; font-size: 12px; }
  main { padding: 16px 24px; max-width: 1200px; margin: 0 auto; }
  .cards { display: flex; gap: 12px; flex-wrap: wrap; margin: 12px 0; }
  .card { background: #fff; border-radius: 8px; padding: 12px 18px;
          box-shadow: 0 1px 3px rgba(0,0,0,.08); min-width: 130px; }
  .card .v { font-size: 24px; font-weight: 600; }
  .card .k { font-size: 12px; color: #667; }
  h2 { font-size: 14px; margin: 18px 0 6px; color: #334; }
  table { border-collapse: collapse; width: 100%; background: #fff;
          border-radius: 8px; overflow: hidden; font-size: 13px;
          box-shadow: 0 1px 3px rgba(0,0,0,.08); }
  th { text-align: left; background: #eef; padding: 6px 10px;
       font-size: 12px; }
  td { padding: 5px 10px; border-top: 1px solid #f0f0f4;
       font-family: ui-monospace, monospace; font-size: 12px; }
  .ALIVE, .RUNNING, .SUCCEEDED, .FINISHED { color: #0a7d33; }
  .DEAD, .FAILED { color: #c0262d; }
  .PENDING, .RESTARTING { color: #b26a00; }
  #err { color: #c0262d; font-size: 12px; }
  tbody tr { cursor: pointer; }
  #panel { position: fixed; top: 0; right: 0; width: 46%; height: 100%;
           background: #fff; box-shadow: -4px 0 16px rgba(0,0,0,.25);
           padding: 14px 18px; overflow: auto; display: none;
           z-index: 10; }
  #panel.open { display: block; }
  #panel h3 { margin: 4px 0 10px; font-size: 14px; }
  #panel pre { background: #16161f; color: #d8d8e8; padding: 10px;
               border-radius: 6px; font-size: 11px; overflow: auto;
               max-height: 45vh; white-space: pre-wrap; }
  #panel .close { float: right; cursor: pointer; font-size: 18px;
                  color: #667; }
  #panel .loglink { color: #2a5bd7; cursor: pointer; display: block;
                    font-family: ui-monospace, monospace; font-size: 12px;
                    padding: 1px 0; }
</style>
</head>
<body>
<header><h1>ray_tpu_torch</h1><span class="sub" id="addr"></span>
<span class="sub" id="ts"></span><span id="err"></span></header>
<div id="panel"><span class="close" onclick="closePanel()">&times;</span>
  <div id="panel-body"></div></div>
<main>
  <div class="cards" id="cards"></div>
  <h2>Cluster CPU utilization (last 5 min)</h2>
  <canvas id="util" width="1160" height="60"
          style="background:#fff;border-radius:8px;width:100%"></canvas>
  <h2>Nodes</h2><table id="nodes"></table>
  <h2>Task timeline (last 60 s, one lane per worker)</h2>
  <canvas id="timeline" width="1160" height="160"
          style="background:#fff;border-radius:8px;width:100%"></canvas>
  <h2>Actors</h2><table id="actors"></table>
  <h2>Jobs</h2><table id="jobs"></table>
  <h2>Serve deployments</h2><table id="serve"></table>
  <h2>Train runs</h2><table id="train"></table>
  <h2>Placement groups</h2><table id="pgs"></table>
  <h2>Recent task events</h2><table id="tasks"></table>
  <h2>Cluster events</h2><table id="events"></table>
</main>
<script>
const fmt = (x) => x === null || x === undefined ? "" :
  (typeof x === "object" ? JSON.stringify(x) : String(x));
const esc = (s) => s.replace(/&/g, "&amp;").replace(/</g, "&lt;")
  .replace(/>/g, "&gt;").replace(/"/g, "&quot;");
const RAW = Symbol("raw-html");  // unforgeable marker for page-built cells
const drill = {};   // table id -> row click handler (drill-down panel)
function table(el, rows, cols) {
  const t = document.getElementById(el);
  if (!rows || !rows.length) { t.innerHTML = "<tr><td>none</td></tr>"; return; }
  t._rows = rows.slice(0, 50);
  if (drill[el] && !t._wired) {
    t._wired = true;
    t.addEventListener("click", ev => {
      const tr = ev.target.closest("tr");
      if (!tr || !tr.parentNode) return;
      const i = [...tr.parentNode.children].indexOf(tr) - 1; // header row
      if (i >= 0 && t._rows && t._rows[i]) drill[el](t._rows[i]);
    });
  }
  let h = "<tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
  for (const r of rows.slice(0, 50)) {
    h += "<tr>" + cols.map(c => {
      // ONLY cells built in this page may carry raw markup — keyed on a
      // Symbol, which is unforgeable through JSON (server data can never
      // produce it, so no column name or value shape reinstates the
      // stored-XSS sink); everything else is escaped BEFORE
      // interpolation: entrypoints / actor names / error strings are
      // workload-controlled
      if (r[c] && typeof r[c] === "object" && r[c][RAW] !== undefined)
        return `<td>${r[c][RAW]}</td>`;
      const v = fmt(r[c]);
      const cls = /^(ALIVE|DEAD|PENDING|RESTARTING|RUNNING|SUCCEEDED|FAILED|FINISHED)$/.test(v) ? ` class="${v}"` : "";
      return `<td${cls}>${esc(v.slice(0, 80))}</td>`;
    }).join("") + "</tr>";
  }
  t.innerHTML = h;
}
async function j(path) {
  const r = await fetch(path);
  if (!r.ok) throw new Error(`${path}: ${r.status} ${await r.text()}`);
  return r.json();
}
function drillSafe(fn) {   // surface drill-down failures in the panel
  return async row => {
    try { await fn(row); }
    catch (e) { panel("error", `<pre>${esc(String(e))}</pre>`); }
  };
}

// ---- metrics history (client-side: each tick appends one sample) ----
const hist = [];            // {t, used, total, perNode: {id: frac}}
function pushSample(cs, nodes) {
  const total = (cs.total_resources || {}).CPU || 0;
  const avail = (cs.available_resources || {}).CPU || 0;
  const perNode = {};
  for (const n of nodes || []) {
    const t = (n.total || {}).CPU || 0, a = (n.available || {}).CPU || 0;
    if (t > 0) perNode[n.node_id] = (t - a) / t;
  }
  hist.push({t: Date.now() / 1000, used: total - avail, total, perNode});
  while (hist.length && hist[0].t < Date.now() / 1000 - 300) hist.shift();
}
function drawUtil() {
  const c = document.getElementById("util"), g = c.getContext("2d");
  g.clearRect(0, 0, c.width, c.height);
  if (hist.length < 2) return;
  const t1 = Date.now() / 1000, t0 = t1 - 300;
  g.beginPath(); g.strokeStyle = "#3b6fd4"; g.lineWidth = 2;
  g.fillStyle = "rgba(59,111,212,.15)";
  const pts = hist.map(h => [
    (h.t - t0) / 300 * c.width,
    c.height - 4 - (h.total ? h.used / h.total : 0) * (c.height - 10)]);
  g.moveTo(pts[0][0], pts[0][1]);
  for (const [x, y] of pts) g.lineTo(x, y);
  g.stroke();
  g.lineTo(pts[pts.length-1][0], c.height); g.lineTo(pts[0][0], c.height);
  g.closePath(); g.fill();
  const h = hist[hist.length - 1];
  g.fillStyle = "#334"; g.font = "11px monospace";
  g.fillText(`${h.used.toFixed(1)}/${h.total} CPU busy`, 8, 14);
}
function sparkline(nodeId) {  // tiny inline chart per node row
  const w = 90, hgt = 18;
  const cv = document.createElement("canvas");
  cv.width = w; cv.height = hgt;
  const g = cv.getContext("2d");
  g.strokeStyle = "#3b6fd4"; g.beginPath();
  const samples = hist.slice(-45);
  samples.forEach((h, i) => {
    const f = h.perNode[nodeId] ?? 0;
    const x = i / Math.max(1, samples.length - 1) * w;
    const y = hgt - 2 - f * (hgt - 4);
    i ? g.lineTo(x, y) : g.moveTo(x, y);
  });
  g.stroke();
  return `<img src="${cv.toDataURL()}" width="${w}" height="${hgt}">`;
}

// ---- task timeline: lanes per worker, spans from state_ts ----
const STATE_COLOR = {FINISHED: "#0a7d33", FAILED: "#c0262d",
                     RUNNING: "#3b6fd4"};
function drawTimeline(records, serverNow) {
  const c = document.getElementById("timeline"), g = c.getContext("2d");
  g.clearRect(0, 0, c.width, c.height);
  // anchor to the SERVER clock: event ts are cluster-host time, and a
  // skewed viewer clock would shift or blank the chart
  const t1 = serverNow || Date.now() / 1000, t0 = t1 - 60;
  const lanes = new Map();  // worker_id -> lane index
  const spans = [];
  for (const r of records || []) {
    const st = r.state_ts || {};
    const start = st.RUNNING ?? st.PENDING_ARGS_AVAIL ?? null;
    if (start === null) continue;
    const end = st.FINISHED ?? st.FAILED ?? t1;  // still running: now
    if (end < t0) continue;
    const key = r.worker_id || r.actor_id || "driver";
    if (!lanes.has(key)) lanes.set(key, lanes.size);
    spans.push({lane: lanes.get(key), s: Math.max(start, t0),
                e: Math.min(end, t1), state: r.state, name: r.name || ""});
  }
  const nl = Math.max(1, Math.min(lanes.size, 12));
  const lh = Math.floor((c.height - 18) / nl);
  g.font = "10px monospace"; g.fillStyle = "#99a";
  for (let m = 0; m <= 6; m++) {  // 10s gridlines
    const x = m / 6 * c.width;
    g.fillRect(x, 0, 1, c.height - 14);
    g.fillText(`-${60 - m * 10}s`, Math.min(x + 2, c.width - 30),
               c.height - 3);
  }
  for (const sp of spans) {
    if (sp.lane >= nl) continue;
    const x0 = (sp.s - t0) / 60 * c.width;
    const x1 = Math.max(x0 + 2, (sp.e - t0) / 60 * c.width);
    g.fillStyle = STATE_COLOR[sp.state] || "#b26a00";
    g.globalAlpha = 0.85;
    g.fillRect(x0, sp.lane * lh + 3, x1 - x0, lh - 6);
    g.globalAlpha = 1;
    if (x1 - x0 > 60) {
      g.fillStyle = "#fff";
      g.fillText(sp.name.slice(0, Math.floor((x1-x0)/7)),
                 x0 + 3, sp.lane * lh + lh / 2 + 3);
    }
  }
  let li = 0;
  g.fillStyle = "#667";
  for (const [k] of lanes) {
    if (li >= nl) break;
    g.fillText(k.slice(0, 10), 2, li * lh + 12);
    li++;
  }
}
// ---- drill-down panel (node detail / actor detail / task record / logs)
function closePanel() { document.getElementById("panel").classList.remove("open"); }
function panel(title, html) {
  document.getElementById("panel-body").innerHTML =
    `<h3>${esc(title)}</h3>` + html;
  document.getElementById("panel").classList.add("open");
}
function miniTable(rows, cols) {
  if (!rows || !rows.length) return "<div>none</div>";
  let h = "<table><tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
  for (const r of rows.slice(0, 40))
    h += "<tr>" + cols.map(c => `<td>${esc(fmt(r[c]).slice(0, 60))}</td>`).join("") + "</tr>";
  return h + "</table>";
}
async function openNode(n) {
  const d = await j("/api/node?node_id=" + encodeURIComponent(n.node_id));
  panel("node " + d.node_id,
    `<pre>${esc(JSON.stringify({addr: d.addr, state: d.state, total: d.total,
      available: d.available, labels: d.labels}, null, 1))}</pre>` +
    "<h3>workers</h3>" + miniTable(d.workers || [],
      ["worker_id", "pid", "state", "actor_id", "blocked"]) +
    "<h3>leases</h3>" + miniTable(d.leases || [],
      ["worker_id", "state", "lease_resources", "bundle_key"]) +
    "<h3>logs</h3>" + (d.logs || []).map(lg =>
      `<span class="loglink" data-log="${esc(lg.name)}">${esc(lg.name)} ` +
      `(${lg.size_bytes ?? "?"} B)</span>`).join("") +
    `<pre id="logview" style="display:none"></pre>`);
  document.getElementById("panel-body").querySelectorAll(".loglink")
    .forEach(a => a.addEventListener("click", async () => {
      const v = document.getElementById("logview");
      v.style.display = "block";
      try {
        const r = await j("/api/log_tail?node_id=" +
          encodeURIComponent(n.node_id) + "&name=" +
          encodeURIComponent(a.dataset.log));
        // textContent: no HTML sink
        v.textContent = r.error ? "ERROR: " + r.error
                                : (r.text || "(empty)");
      } catch (e) { v.textContent = "ERROR: " + e; }
    }));
}
async function openActor(a) {
  const d = await j("/api/actor?actor_id=" + encodeURIComponent(a.actor_id));
  const evs = d.task_events || [];
  delete d.task_events;
  panel("actor " + a.actor_id,
    `<pre>${esc(JSON.stringify(d, null, 1))}</pre>` +
    "<h3>recent tasks</h3>" +
    miniTable(evs, ["task_id", "name", "state", "error"]));
}
function openTask(t) {
  panel("task " + t.task_id, `<pre>${esc(JSON.stringify(t, null, 1))}</pre>`);
}
drill.nodes = drillSafe(openNode); drill.actors = drillSafe(openActor);
drill.tasks = drillSafe(openTask);
document.addEventListener("keydown", e => { if (e.key === "Escape") closePanel(); });

async function tick() {
  try {
    const [cs, nodes, actors, jobs, pgs, tasks, events, ver, serve,
           train] =
      await Promise.all([
      j("/api/cluster_status"), j("/api/nodes"), j("/api/actors"),
      j("/api/jobs"), j("/api/placement_groups"),
      j("/api/tasks?limit=50"), j("/api/events?limit=30"),
      j("/api/version"), j("/api/serve"), j("/api/train")]);
    document.getElementById("addr").textContent = ver.control_address;
    const total = cs.total_resources || {}, avail = cs.available_resources || {};
    const card = (k, v) => `<div class="card"><div class="v">${v}</div><div class="k">${k}</div></div>`;
    document.getElementById("cards").innerHTML =
      card("alive nodes", cs.alive_nodes) +
      card("CPU free/total", `${avail.CPU ?? 0}/${total.CPU ?? 0}`) +
      card("GPU free/total", `${avail.GPU ?? 0}/${total.GPU ?? 0}`) +
      card("actors", actors.length) + card("jobs", jobs.length) +
      card("placement groups", pgs.length);
    pushSample(cs, nodes);
    drawUtil();
    drawTimeline(tasks.records || [], tasks.now);
    for (const n of nodes || []) n.util = {[RAW]: sparkline(n.node_id)};
    table("nodes", nodes, ["node_id", "addr", "state", "total", "available", "util", "labels"]);
    table("actors", actors, ["actor_id", "class_name", "name", "state", "node_id", "restarts"]);
    table("jobs", jobs, ["submission_id", "entrypoint", "status", "message"]);
    const srows = [];
    for (const a of (serve.apps || []))
      for (const d of (a.deployments || []))
        srows.push({app: a.app, route: a.route_prefix, ...d,
                    app_status: a.status});
    table("serve", srows, ["app", "route", "deployment", "status",
                           "replicas", "ongoing", "message"]);
    const trows = (train || []).map(r => ({...r,
      metrics: r.last_metrics ? JSON.stringify(r.last_metrics).slice(0, 70) : ""}));
    table("train", trows, ["name", "trial", "status", "workers",
                           "rounds", "metrics"]);
    table("pgs", pgs, ["pg_id", "name", "state", "bundles", "strategy"]);
    table("tasks", tasks.records || [], ["task_id", "name", "state", "actor_id", "error"]);
    const evs = (events || []).slice().reverse().map(e => ({
      ...e, when: new Date(e.ts * 1000).toLocaleTimeString()}));
    table("events", evs, ["when", "severity", "source", "event_type", "entity_id", "message"]);
    document.getElementById("ts").textContent = new Date().toLocaleTimeString();
    document.getElementById("err").textContent = "";
  } catch (e) { document.getElementById("err").textContent = " " + e; }
}
tick(); setInterval(tick, 2000);
</script>
</body>
</html>
"""
