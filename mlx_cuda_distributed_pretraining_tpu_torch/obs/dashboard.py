"""Self-contained live training dashboard for the stats hub.

The JAX package's ``obs/dashboard.py``, with ``DASHBOARD_HTML`` byte for
byte the same: a single HTML file with no external assets (vanilla canvas
rendering) for a machine with no network, connecting to the WebSocket hub
(obs/stats_server.py) and charting per-worker loss and aggregate
throughput plus a live worker table.

Serve it with ``python -m
mlx_cuda_distributed_pretraining_tpu_torch.obs.stats_server --http-port
8080`` or write it anywhere with :func:`write_dashboard`.
"""

from __future__ import annotations

import os

# Palette: categorical slots in fixed order (assigned per worker_id in
# arrival order, never re-cycled on filter), validated for light and dark
# surfaces; text wears text tokens, never series colors.
DASHBOARD_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>Training dashboard</title>
<style>
  :root {
    color-scheme: light;
    --surface-1: #fcfcfb;
    --surface-2: #f1f0ee;
    --text-primary: #0b0b0b;
    --text-secondary: #52514e;
    --grid: #e3e2df;
    --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
    --series-4: #eda100; --series-5: #e87ba4; --series-6: #008300;
    --series-7: #4a3aa7; --series-8: #e34948;
    --status-good: #008300; --status-critical: #e34948;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      color-scheme: dark;
      --surface-1: #1a1a19;
      --surface-2: #242423;
      --text-primary: #ffffff;
      --text-secondary: #c3c2b7;
      --grid: #343431;
      --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
      --series-4: #c98500; --series-5: #d55181; --series-6: #008300;
      --series-7: #9085e9; --series-8: #e66767;
    }
  }
  body { margin: 0; background: var(--surface-1); color: var(--text-primary);
         font: 13px/1.45 system-ui, sans-serif; }
  .wrap { max-width: 1100px; margin: 0 auto; padding: 20px; }
  h1 { font-size: 16px; font-weight: 600; margin: 0 0 4px; }
  .sub { color: var(--text-secondary); margin-bottom: 16px; }
  .tiles { display: flex; gap: 12px; flex-wrap: wrap; margin-bottom: 20px; }
  .tile { background: var(--surface-2); border-radius: 8px; padding: 12px 16px;
          min-width: 130px; }
  .tile .v { font-size: 22px; font-weight: 600; font-variant-numeric: tabular-nums; }
  .tile .l { color: var(--text-secondary); font-size: 12px; }
  .panel { background: var(--surface-2); border-radius: 8px; padding: 14px 16px;
           margin-bottom: 16px; }
  .panel h2 { font-size: 13px; font-weight: 600; margin: 0 0 8px; }
  canvas { width: 100%; height: 220px; display: block; }
  .legend { display: flex; gap: 14px; flex-wrap: wrap; margin-top: 6px;
            color: var(--text-secondary); font-size: 12px; }
  .legend .key { display: inline-flex; align-items: center; gap: 5px; }
  .legend .sw { width: 10px; height: 10px; border-radius: 3px; display: inline-block; }
  table { border-collapse: collapse; width: 100%; font-variant-numeric: tabular-nums; }
  th { text-align: left; color: var(--text-secondary); font-weight: 500;
       border-bottom: 1px solid var(--grid); padding: 4px 10px 4px 0; }
  td { padding: 4px 10px 4px 0; border-bottom: 1px solid var(--grid); }
  .dot { width: 8px; height: 8px; border-radius: 50%; display: inline-block;
         margin-right: 6px; }
  #tip { position: fixed; pointer-events: none; background: var(--surface-1);
         border: 1px solid var(--grid); border-radius: 6px; padding: 6px 9px;
         font-size: 12px; display: none; box-shadow: 0 2px 8px rgba(0,0,0,.15); }
  .conn { font-size: 12px; }
</style>
</head>
<body>
<div class="wrap">
  <h1>Training dashboard</h1>
  <div class="sub conn" id="conn">connecting…</div>
  <div class="tiles">
    <div class="tile"><div class="v" id="t-step">–</div><div class="l">max step</div></div>
    <div class="tile"><div class="v" id="t-loss">–</div><div class="l">mean loss</div></div>
    <div class="tile"><div class="v" id="t-toks">–</div><div class="l">total tok/s</div></div>
    <div class="tile"><div class="v" id="t-mfu">–</div><div class="l">MFU</div></div>
    <div class="tile"><div class="v" id="t-workers">–</div><div class="l">workers alive</div></div>
  </div>
  <div class="panel">
    <h2>Loss by step</h2>
    <canvas id="loss"></canvas>
    <div class="legend" id="loss-legend"></div>
  </div>
  <div class="panel">
    <h2>Throughput (total tok/s)</h2>
    <canvas id="tput"></canvas>
  </div>
  <div class="panel">
    <h2>Goodput (last window, mean across workers)</h2>
    <canvas id="goodput" style="height: 46px"></canvas>
    <div class="legend" id="goodput-legend"></div>
  </div>
  <div class="panel">
    <h2>Workers</h2>
    <table id="workers"><thead><tr>
      <th></th><th>worker</th><th>step</th><th>loss</th><th>tok/s</th><th>mfu</th><th>moe ent</th><th>cache hit</th><th>ttft p50/p95</th><th>mesh</th><th>weights</th><th>alerts</th><th>last seen</th>
    </tr></thead><tbody></tbody></table>
  </div>
</div>
<div id="tip"></div>
<script>
"use strict";
const css = n => getComputedStyle(document.documentElement).getPropertyValue(n).trim();
const SERIES = [1,2,3,4,5,6,7,8].map(i => "--series-" + i);
const workersSeen = [];          // arrival order -> fixed slot, never re-cycled
const history = [];              // {t, worker_id, step, loss, "tok/s"}
const tputHist = [];             // {t, total}
function slotOf(wid) {
  let i = workersSeen.indexOf(wid);
  if (i < 0) { workersSeen.push(wid); i = workersSeen.length - 1; }
  return css(SERIES[Math.min(i, SERIES.length - 1)]);
}
function fmt(x, d) { return (x === null || x === undefined) ? "–" :
  (typeof x === "number" ? x.toFixed(d === undefined ? 2 : d) : String(x)); }

function sizeCanvas(cv) {
  const r = cv.getBoundingClientRect(), dpr = window.devicePixelRatio || 1;
  cv.width = r.width * dpr; cv.height = r.height * dpr;
  const g = cv.getContext("2d"); g.setTransform(dpr, 0, 0, dpr, 0, 0);
  return [g, r.width, r.height];
}

function drawAxes(g, W, H, pad, xmin, xmax, ymin, ymax, xlab) {
  g.strokeStyle = css("--grid"); g.fillStyle = css("--text-secondary");
  g.lineWidth = 1; g.font = "11px system-ui";
  for (let i = 0; i <= 4; i++) {
    const y = pad.t + (H - pad.t - pad.b) * i / 4;
    g.beginPath(); g.moveTo(pad.l, y); g.lineTo(W - pad.r, y); g.stroke();
    const v = ymax - (ymax - ymin) * i / 4;
    g.fillText(fmt(v, Math.abs(ymax) > 100 ? 0 : 3), 4, y + 4);
  }
  for (let i = 0; i <= 4; i++) {
    const x = pad.l + (W - pad.l - pad.r) * i / 4;
    const v = xmin + (xmax - xmin) * i / 4;
    g.fillText(xlab(v), x - 10, H - 4);
  }
}

const tip = document.getElementById("tip");
function attachHover(cv, pick) {
  cv.addEventListener("mousemove", e => {
    const r = cv.getBoundingClientRect();
    const hit = pick(e.clientX - r.left, e.clientY - r.top);
    if (!hit) { tip.style.display = "none"; return; }
    tip.innerHTML = hit;
    tip.style.display = "block";
    tip.style.left = (e.clientX + 14) + "px";
    tip.style.top = (e.clientY + 14) + "px";
  });
  cv.addEventListener("mouseleave", () => tip.style.display = "none");
}

// ---- loss chart: per-worker lines over step -------------------------------
const lossCv = document.getElementById("loss");
let lossPts = [];  // flat points for hover: {x, y, wid, step, loss, px, py}
function drawLoss() {
  const [g, W, H] = sizeCanvas(lossCv);
  const pad = {l: 46, r: 10, t: 8, b: 18};
  g.clearRect(0, 0, W, H);
  const byW = new Map();
  for (const h of history) {
    if (typeof h.loss !== "number" || typeof h.step !== "number") continue;
    if (!byW.has(h.worker_id)) byW.set(h.worker_id, []);
    byW.get(h.worker_id).push(h);
  }
  lossPts = [];
  if (!byW.size) return;
  let xmin = 1e18, xmax = -1e18, ymin = 1e18, ymax = -1e18;
  for (const pts of byW.values()) for (const p of pts) {
    xmin = Math.min(xmin, p.step); xmax = Math.max(xmax, p.step);
    ymin = Math.min(ymin, p.loss); ymax = Math.max(ymax, p.loss);
  }
  if (xmin === xmax) { xmin -= 1; xmax += 1; }
  if (ymin === ymax) { ymin -= 0.5; ymax += 0.5; }
  const X = s => pad.l + (W - pad.l - pad.r) * (s - xmin) / (xmax - xmin);
  const Y = v => pad.t + (H - pad.t - pad.b) * (1 - (v - ymin) / (ymax - ymin));
  drawAxes(g, W, H, pad, xmin, xmax, ymin, ymax, v => Math.round(v));
  const legend = document.getElementById("loss-legend");
  legend.innerHTML = "";
  for (const [wid, pts] of byW) {
    pts.sort((a, b) => a.step - b.step);
    const color = slotOf(wid);
    g.strokeStyle = color; g.lineWidth = 2; g.beginPath();
    pts.forEach((p, i) => {
      const px = X(p.step), py = Y(p.loss);
      if (i === 0) g.moveTo(px, py); else g.lineTo(px, py);
      lossPts.push({wid, step: p.step, loss: p.loss, px, py});
    });
    g.stroke();
    if (byW.size >= 2) {
      const k = document.createElement("span");
      k.className = "key";
      k.innerHTML = '<span class="sw" style="background:' + color + '"></span>' + wid;
      legend.appendChild(k);
    }
  }
}
attachHover(lossCv, (mx, my) => {
  let best = null, bd = 400;
  for (const p of lossPts) {
    const d = (p.px - mx) ** 2 + (p.py - my) ** 2;
    if (d < bd) { bd = d; best = p; }
  }
  return best && "<b>" + best.wid + "</b><br>step " + best.step +
         " · loss " + best.loss.toFixed(4);
});

// ---- throughput chart: single aggregate series over time ------------------
const tputCv = document.getElementById("tput");
let tputPts = [];
function drawTput() {
  const [g, W, H] = sizeCanvas(tputCv);
  const pad = {l: 64, r: 10, t: 8, b: 18};
  g.clearRect(0, 0, W, H);
  tputPts = [];
  if (tputHist.length < 2) return;
  const t0 = tputHist[0].t, t1 = tputHist[tputHist.length - 1].t || t0 + 1;
  let ymax = Math.max(...tputHist.map(p => p.total)) * 1.1 || 1;
  const X = t => pad.l + (W - pad.l - pad.r) * (t - t0) / Math.max(t1 - t0, 1);
  const Y = v => pad.t + (H - pad.t - pad.b) * (1 - v / ymax);
  drawAxes(g, W, H, pad, 0, (t1 - t0), 0, ymax, v => Math.round(v) + "s");
  g.strokeStyle = css("--series-1"); g.lineWidth = 2; g.beginPath();
  tputHist.forEach((p, i) => {
    const px = X(p.t), py = Y(p.total);
    if (i === 0) g.moveTo(px, py); else g.lineTo(px, py);
    tputPts.push({px, py, t: p.t - t0, total: p.total});
  });
  g.stroke();
}
attachHover(tputCv, (mx, my) => {
  let best = null, bd = 400;
  for (const p of tputPts) {
    const d = (p.px - mx) ** 2 + (p.py - my) ** 2;
    if (d < bd) { bd = d; best = p; }
  }
  return best && Math.round(best.total).toLocaleString() + " tok/s<br>t+" +
         Math.round(best.t) + "s";
});

// ---- goodput breakdown: stacked bar of the latest window's components -----
const GP_KEYS = ["dispatch_s", "compile_s", "data_wait_s", "h2d_wait_s",
                 "ckpt_save_s", "eval_s", "other_s"];
const gpCv = document.getElementById("goodput");
function drawGoodput(workers) {
  const [g, W, H] = sizeCanvas(gpCv);
  g.clearRect(0, 0, W, H);
  const legend = document.getElementById("goodput-legend");
  const sums = {}, counts = {};
  for (const w of Object.values(workers)) {
    const m = w.metrics || {};
    for (const k of GP_KEYS) {
      if (typeof m[k] === "number") {
        sums[k] = (sums[k] || 0) + m[k];
        counts[k] = (counts[k] || 0) + 1;
      }
    }
  }
  const means = GP_KEYS.map(k => counts[k] ? sums[k] / counts[k] : 0);
  const total = means.reduce((a, b) => a + b, 0);
  if (!total) { legend.textContent = "(no goodput data yet)"; return; }
  legend.innerHTML = "";
  let x = 0;
  GP_KEYS.forEach((k, i) => {
    const frac = means[i] / total;
    if (frac <= 0) return;
    const color = css(SERIES[i % SERIES.length]);
    g.fillStyle = color;
    g.fillRect(x, 8, W * frac, H - 16);
    x += W * frac;
    const span = document.createElement("span");
    span.className = "key";
    span.innerHTML = '<span class="sw" style="background:' + color + '"></span>' +
      k.replace(/_s$/, "") + " " + (100 * frac).toFixed(1) + "%";
    legend.appendChild(span);
  });
}

// ---- worker table + tiles -------------------------------------------------
function renderWorkers(workers, agg) {
  document.getElementById("t-step").textContent = fmt(agg.max_step, 0);
  document.getElementById("t-loss").textContent = fmt(agg.mean_loss, 4);
  document.getElementById("t-toks").textContent =
    agg.total_tok_s ? Math.round(agg.total_tok_s).toLocaleString() : "–";
  document.getElementById("t-mfu").textContent =
    (typeof agg.mean_mfu === "number") ? (100 * agg.mean_mfu).toFixed(1) + "%" : "–";
  document.getElementById("t-workers").textContent =
    fmt(agg.alive_workers, 0) + "/" + fmt(agg.num_workers, 0);
  const tb = document.querySelector("#workers tbody");
  tb.innerHTML = "";
  const now = Date.now() / 1000;
  for (const [wid, w] of Object.entries(workers)) {
    const m = w.metrics || {};
    const ago = now - (w.last_seen || 0);
    const alive = ago < 60;
    const tr = document.createElement("tr");
    tr.innerHTML =
      '<td><span class="dot" style="background:' + slotOf(wid) + '"></span></td>' +
      "<td>" + wid + "</td><td>" + fmt(w.step, 0) + "</td>" +
      "<td>" + fmt(m.loss, 4) + "</td>" +
      "<td>" + (m["tok/s"] ? Math.round(m["tok/s"]).toLocaleString() : "–") + "</td>" +
      "<td>" + (typeof m.mfu === "number" ? (100 * m.mfu).toFixed(1) + "%" : "–") + "</td>" +
      // MoE runs only: normalized routing entropy + dropped selections
      // (absent keys render "–", so dense runs are unaffected).
      "<td>" + (typeof m.moe_entropy === "number" ? m.moe_entropy.toFixed(3) +
        (m.moe_drop ? " / drop " + m.moe_drop : "") : "–") + "</td>" +
      // Serving workers only: prefix-cache hit rate (fraction of offered
      // prompt tokens served from cached KV blocks; training rows "–").
      "<td>" + (typeof m.prefix_cache_hit_rate === "number" ?
        (100 * m.prefix_cache_hit_rate).toFixed(1) + "%" : "–") + "</td>" +
      // Serving workers only: TTFT histogram quantiles (ms). p95 needs
      // its own key; older engines publish only the p50-backed ttft_ms.
      "<td>" + (typeof m.ttft_ms_p50 === "number" ?
        m.ttft_ms_p50.toFixed(0) + (typeof m.ttft_ms_p95 === "number" ?
          " / " + m.ttft_ms_p95.toFixed(0) : "") : "–") + "</td>" +
      // Serving workers only: mesh shape ("tp=2" / "1dev"; training "–").
      "<td>" + (typeof m.mesh === "string" ? m.mesh : "–") + "</td>" +
      // Serving weight dtype ("fp" / "int8" / "int4"; training "–").
      "<td>" + (typeof m.weight_dtype === "string" ? m.weight_dtype : "–") + "</td>" +
      // graftscope column: workers whose stats carry a firing-alert
      // count (GET /alerts fed by obs/scope.py). Absent key -> "–" so
      // fleets without a collector render unchanged.
      "<td>" + (typeof m.alerts_firing === "number" ?
        (m.alerts_firing > 0 ?
          '<span style="color:var(--status-critical)">\\u26a0 ' +
            m.alerts_firing.toFixed(0) + "</span>" : "0") : "–") + "</td>" +
      '<td style="color:var(' + (alive ? "--status-good" : "--status-critical") +
      ')">' + (alive ? "\\u25cf " + Math.round(ago) + "s ago" : "\\u25cb stale") + "</td>";
    tb.appendChild(tr);
  }
  drawGoodput(workers);
}

// ---- WS wiring ------------------------------------------------------------
const WS_URL = (location.search.match(/ws=([^&]+)/) || [])[1] ||
               "ws://" + location.hostname + ":__WS_PORT__";
function connect() {
  const conn = document.getElementById("conn");
  let ws;
  try { ws = new WebSocket(WS_URL); }
  catch (e) { conn.textContent = "bad ws url " + WS_URL; return; }
  ws.onopen = () => conn.textContent = "live · " + WS_URL;
  ws.onclose = () => { conn.textContent = "disconnected — retrying…";
                       setTimeout(connect, 2000); };
  ws.onmessage = ev => {
    const msg = JSON.parse(ev.data);
    if (msg.type === "initial_state") {
      history.length = 0;
      for (const h of msg.history || []) history.push(h);
      renderWorkers(msg.workers || {}, msg.aggregated || {});
    } else if (msg.type === "update") {
      // updates carry the latest per-worker metrics; append unseen steps
      for (const [wid, w] of Object.entries(msg.workers || {})) {
        const m = w.metrics || {};
        if (typeof m.loss === "number" && typeof w.step === "number") {
          const last = history.filter(h => h.worker_id === wid).pop();
          if (!last || last.step !== w.step)
            history.push({t: w.last_seen, worker_id: wid, step: w.step,
                          loss: m.loss, "tok/s": m["tok/s"]});
        }
      }
      renderWorkers(msg.workers || {}, msg.aggregated || {});
      if (msg.aggregated && msg.aggregated.total_tok_s)
        tputHist.push({t: Date.now() / 1000, total: msg.aggregated.total_tok_s});
    }
    if (history.length > 4000) history.splice(0, history.length - 4000);
    if (tputHist.length > 2000) tputHist.splice(0, 1000);
    drawLoss(); drawTput();
  };
}
connect();
window.addEventListener("resize", () => { drawLoss(); drawTput(); });
</script>
</body>
</html>
"""


def render_dashboard(ws_port: int = 8765) -> str:
    """The dashboard HTML pointed at the given WS hub port."""
    return DASHBOARD_HTML.replace("__WS_PORT__", str(int(ws_port)))


def write_dashboard(path: str, ws_port: int = 8765) -> str:
    """Write the dashboard HTML to ``path`` (creating parent dirs)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(render_dashboard(ws_port))
    return path


def serve_dashboard(host: str = "127.0.0.1", port: int = 8080, ws_port: int = 8765):
    """Serve the dashboard over HTTP in a daemon thread; returns the server.

    The page connects to the WS hub on the same hostname at ``ws_port``
    unless overridden with ``?ws=ws://host:port``.
    """
    import http.server
    import threading

    page = render_dashboard(ws_port)

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            body = page.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # silence per-request noise
            pass

    srv = http.server.ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
