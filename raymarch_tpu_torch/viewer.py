"""Interactive viewer: the app-shell layer (reference L4, src/main.rs:9-83).

The port of `raymarch_tpu/viewer.py`. The reference is an eframe desktop
app: an egui node-graph editor on the left, the rendered viewport on the
right, and mouse input routed to an orbit camera (src/main.rs:44-82). This
module is the equivalent as a tiny dependency-free HTTP app: the browser
page is the window, the server owns ALL state (graph, camera rig, compiled
tape), and every frame follows the reference's per-frame pipeline: edit
graph -> evaluate_root -> re-encode tape (a buffer swap, no rebuild) ->
render on the card -> present.

Input mapping mirrors src/main.rs:58-69: primary-button drag => Orbit,
secondary-button drag => Pan, scroll => Dolly (the reference's CameraEvent
enum, src/camera.rs:15-19), applied to the same OrbitCameraController rig
(utils/camera.py).

`ViewerApp` is the headless core (tests/test_torch_viewer.py); `serve()`
wraps it in a ThreadingHTTPServer. Run:

    python -m raymarch_tpu_torch.viewer [--port 8000] [--size 960x540] [--backend B] [--cpu] [--aa N]

On the card by default (the cone-prepass kernels through the tiered
runtime); `--cpu` renders with the "jnp" backend on the CPU. Without
`--cpu` and without a GPU it raises.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, Optional

import numpy as np

from .config import DEFAULT_CONFIG, RenderConfig
from .models.graph import CSGNodeGraph
from .ops.tape import compile_scene
from .runtime import to_numpy
from .utils.camera import OrbitCameraController
from .utils.image import png_bytes


def default_graph() -> CSGNodeGraph:
    """The demo scene: (sphere | box) - torus, mirroring BASELINE config 2."""
    g = CSGNodeGraph()
    root = g.add_root()
    s = g.add_node("Sphere", center=(-0.6, 0.0, 0.0), radius=0.9)
    b = g.add_node("Box", center=(0.8, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5))
    t = g.add_node(
        "Torus", center=(0.0, 0.8, 0.0), major_radius=0.7, minor_radius=0.25
    )
    u = g.add_node("Union")
    d = g.add_node("Subtraction")
    g.connect(s, u, "A")
    g.connect(b, u, "B")
    g.connect(u, d, "A")
    g.connect(t, d, "B")
    g.connect(d, root, "SDF")
    return g


class ViewerApp:
    """Headless app state + per-frame pipeline (reference main.rs:44-82).

    Renderers are cached per TapeSpec: geometry-parameter edits re-use the
    renderer (the reference's "no shader recompile" property, README.md:7);
    structural edits within the tape's bucket keep the TapeSpec of the
    dynamic tape and re-use it too. "compiles" counts the renderers built
    (per TapeSpec), or with the tiered runtime its static tiers.

    `device` is "cuda" (the default; RuntimeError without a GPU) or "cpu".
    The backend defaults to "pallas_prepass" on the card and "jnp" on the
    CPU; the pallas backends serve frames through the tiered runtime.
    """

    def __init__(
        self,
        graph: Optional[CSGNodeGraph] = None,
        width: int = 512,
        height: int = 288,
        cfg: Optional[RenderConfig] = None,
        backend: Optional[str] = None,
        static: bool = False,
        tiered: Optional[bool] = None,
        *,
        device="cuda",
    ):
        from .ops.cuda_prepass import resolve_device

        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.cfg = cfg or DEFAULT_CONFIG
        if backend is None:
            backend = "pallas_prepass" if self.device.type == "cuda" else "jnp"
        self.backend = backend
        # Dynamic tape by default, like the reference: EVERY edit (including
        # topology and materials) is a buffer swap that builds nothing.
        # static=True trades a renderer per topology for the static tape's
        # faster frames.
        self.static = static
        # Tiered execution (runtime.TieredRenderer): a topology edit's first
        # frames come from the dynamic tier while the static tier warms in
        # the background, then switch over. Default on for the kernel
        # backends; the jnp backend keeps the single-tier path.
        if tiered is None:
            tiered = backend.startswith("pallas") and not static
        self._tiered = None
        if tiered:
            from .runtime import TieredRenderer

            self._tiered = TieredRenderer(width, height, self.cfg, backend=backend, device=self.device)
        self.graph = graph if graph is not None else default_graph()
        self.camera = OrbitCameraController(target=(0.0, 0.0, 0.0), radius=4.5)
        self.camera.orbit(0.0, 35.0)  # start slightly above the horizon
        self._renderers: Dict[Any, Any] = {}
        self._lock = threading.Lock()
        self.frames_rendered = 0
        self.compiles = 0
        # Editor-only state (reference GraphEditorState node positions,
        # csg_node_graph.rs:233-239): node id -> [x, y] canvas coords.
        self.node_pos: Dict[int, list] = {}
        self._auto_layout()

    def _auto_layout(self) -> None:
        """Assign canvas positions to nodes that lack one: simple
        topological columns (primitives left, Root right)."""
        depth: Dict[int, int] = {}

        def d(nid, seen=()):
            if nid in depth:
                return depth[nid]
            if nid in seen:
                return 0
            node = self.graph.nodes[nid]
            kids = [
                v[1]
                for v in node.inputs.values()
                if isinstance(v, tuple) and len(v) == 2 and v[0] == "node"
            ]
            depth[nid] = 1 + max((d(k, seen + (nid,)) for k in kids), default=0)
            return depth[nid]

        per_col: Dict[int, int] = {}
        for nid in sorted(self.graph.nodes):
            if nid in self.node_pos:
                continue
            col = d(nid) - 1
            row = per_col.get(col, 0)
            per_col[col] = row + 1
            self.node_pos[nid] = [30 + col * 190, 30 + row * 150]

    # -- input events (reference src/main.rs:58-69) ----------------------
    def handle_event(self, ev: Dict[str, Any]) -> None:
        kind = ev.get("type")
        with self._lock:
            if kind == "orbit":
                self.camera.orbit(float(ev.get("dx", 0)), float(ev.get("dy", 0)))
            elif kind == "pan":
                self.camera.pan(float(ev.get("dx", 0)), float(ev.get("dy", 0)))
            elif kind == "dolly":
                self.camera.dolly(float(ev.get("delta", 0)))
            else:
                raise ValueError(f"unknown event type: {kind!r}")

    # -- graph API --------------------------------------------------------
    def graph_dict(self) -> Dict[str, Any]:
        with self._lock:
            out = self.graph.to_dict()
            out["pos"] = {str(k): list(v) for k, v in self.node_pos.items()}
            return out

    def set_graph(self, data: Dict[str, Any]) -> None:
        g = CSGNodeGraph.from_dict(data)  # validate before swapping in
        with self._lock:
            self.graph = g
            pos = data.get("pos", {})
            self.node_pos = {
                int(k): [float(v[0]), float(v[1])] for k, v in pos.items()
                if int(k) in g.nodes
            }
            self._auto_layout()

    def templates(self) -> Dict[str, Any]:
        """Node palette for the editor: template -> input specs."""
        from .models.graph import TEMPLATES

        return {
            name: [
                {"name": s.name, "kind": s.kind, "default": s.default}
                for s in tpl.inputs
            ]
            for name, tpl in TEMPLATES.items()
        }

    def edit(self, op: Dict[str, Any]) -> Dict[str, Any]:
        """Fine-grained graph edits for the visual editor (the reference's
        egui node editor interactions, csg_node_graph.rs:185-206 widgets and
        wire connect/disconnect). Every op is validated by the graph model;
        bad ops raise and surface as HTTP 400."""
        with self._lock:
            kind = op.get("op")
            if kind == "add":
                nid = self.graph.add_node(op["template"])
                self.node_pos[nid] = [float(v) for v in op.get("pos", (40, 40))]
                return {"id": nid}
            if kind == "remove":
                self.graph.remove_node(int(op["id"]))
                self.node_pos.pop(int(op["id"]), None)
                return {}
            if kind == "connect":
                self.graph.connect(int(op["src"]), int(op["dst"]), op["input"])
                return {}
            if kind == "disconnect":
                self.graph.disconnect(int(op["dst"]), op["input"])
                return {}
            if kind == "set_input":
                v = op["value"]
                self.graph.set_input(
                    int(op["id"]), op["name"],
                    tuple(v) if isinstance(v, list) else float(v),
                )
                return {}
            if kind == "move":
                self.node_pos[int(op["id"])] = [
                    float(op["pos"][0]), float(op["pos"][1])
                ]
                return {}
            raise ValueError(f"unknown edit op: {kind!r}")

    # -- per-frame pipeline ------------------------------------------------
    def _renderer_for(self, spec):
        rnd = self._renderers.get(spec)
        if rnd is None:
            from .ops.march import make_renderer

            chunk = None if self.backend.startswith("pallas") else 1 << 16
            rnd = make_renderer(
                spec,
                self.width,
                self.height,
                self.cfg,
                mode="forward",
                backend=self.backend,
                chunk=chunk,
                device=self.device,
            )
            self._renderers[spec] = rnd
            self.compiles += 1
        return rnd

    def prewarm(self) -> threading.Thread:
        """Render the current scene once on a background thread, so that
        the first browser request does not pay the kernels' first build
        (nvcc at first use). With tiered execution this warms the dynamic
        tier AND kicks the static tier; `frame()` serialises behind the app
        lock either way. Returns the thread."""
        t = threading.Thread(target=self.frame, daemon=True, name="viewer-prewarm")
        t.start()
        return t

    def frame(self) -> np.ndarray:
        """edit-aware render: evaluate_root -> tape swap -> render -> numpy
        f32[H, W, 3]."""
        with self._lock:
            scene = self.graph.evaluate_root()  # None => background only
            if self._tiered is not None:
                out = self._tiered.render(scene, self.camera.camera())
                self.compiles = self._tiered.static_compiles
                self.frames_rendered += 1
                return out
            spec, arrays = compile_scene(scene, static=self.static)
            out = to_numpy(self._renderer_for(spec)(arrays, self.camera.camera()))
            self.frames_rendered += 1
            return out

    def frame_png(self) -> bytes:
        return png_bytes(self.frame())

    def state(self) -> Dict[str, Any]:
        c = self.camera
        out = {
            "pitch": c.pitch,
            "yaw": c.yaw,
            "radius": c.radius,
            "target": list(map(float, c.target)),
            "backend": self.backend,
            "device": str(self.device),
            "size": [self.width, self.height],
            "frames": self.frames_rendered,
            "compiles": self.compiles,
            "tier": self._tiered.tier if self._tiered is not None else "single",
        }
        if self._tiered is not None:
            # Tier telemetry for the status bar (runtime.TieredRenderer):
            # which tier served recent frames, cached static tiers,
            # in-flight background builds.
            out["tiered"] = self._tiered.stats()
        return out


_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>raymarch_tpu_torch viewer</title>
<style>
 body { margin:0; background:#15161a; color:#cfd2d8; font:13px monospace;
        display:flex; height:100vh; }
 #left { width:620px; min-width:380px; padding:10px; display:flex;
         flex-direction:column; border-right:1px solid #2a2d34; }
 #right { flex:1; display:flex; align-items:center; justify-content:center; }
 #view { image-rendering:auto; max-width:100%; max-height:100%;
         cursor:grab; user-select:none; -webkit-user-drag:none; }
 #toolbar { display:flex; gap:6px; margin-bottom:8px; align-items:center; }
 select, button { background:#2a2d34; color:#cfd2d8; border:1px solid #444;
                  padding:5px; cursor:pointer; font:12px monospace; }
 #editor { position:relative; flex:1; background:#101114; overflow:auto;
           border:1px solid #2a2d34; }
 #wires { position:absolute; left:0; top:0; width:2200px; height:2200px;
          pointer-events:none; }
 .node { position:absolute; min-width:150px; background:#1d1f24;
         border:1px solid #3a3f48; border-radius:5px; font-size:11px; }
 .node .title { background:#262a31; padding:4px 6px; cursor:move;
                border-radius:5px 5px 0 0; display:flex;
                justify-content:space-between; }
 .node .title .del { cursor:pointer; color:#8a8f98; padding:0 3px; }
 .node .title .del:hover { color:#ff7b72; }
 .row { display:flex; align-items:center; gap:4px; padding:2px 6px;
        position:relative; }
 .row label { width:78px; color:#8a8f98; overflow:hidden; }
 .row input { width:44px; background:#15161a; color:#cfd2d8;
              border:1px solid #333; font:11px monospace; padding:1px 2px; }
 .port { width:10px; height:10px; border-radius:50%; border:1px solid #6fa8dc;
         background:#15161a; cursor:crosshair; flex:none; }
 .port.full { background:#6fa8dc; }
 .outport { position:absolute; right:-6px; top:50%; margin-top:-5px;
            border-color:#93c47d; }
 .outport.full { background:#93c47d; }
 #status { margin-top:6px; min-height:2.5em; color:#8a8f98; }
 h3 { margin:2px 0 8px; font-size:13px; }
 path.wire { stroke:#6fa8dc; stroke-width:1.6; fill:none; opacity:.85; }
 path.temp { stroke:#e0b35a; stroke-dasharray:4 3; }
</style></head><body>
<div id="left">
 <h3>raymarch_tpu_torch &mdash; CSG node editor</h3>
 <div id="toolbar">
  <select id="tplsel"></select>
  <button id="addnode">+ add node</button>
  <span style="color:#8a8f98">drag title: move &middot; drag &#9679;&rarr;&#9675;:
   connect &middot; click filled port: disconnect</span>
 </div>
 <div id="editor"><svg id="wires"></svg></div>
 <div id="status">viewport &mdash; drag: orbit &middot; right-drag: pan &middot; wheel: dolly</div>
 <div id="telemetry" style="color:#5d88b3; min-height:1.2em;"></div>
</div>
<div id="right"><img id="view" draggable="false"></div>
<script>
const view = document.getElementById('view');
const status_ = document.getElementById('status');
const editor = document.getElementById('editor');
const wires = document.getElementById('wires');
let G = null, TPL = null;

// ---- frame loop ------------------------------------------------------------
let inflight = false;
async function tick() {
  if (!inflight) {
    inflight = true;
    try {
      const r = await fetch('/frame.png?t=' + performance.now());
      const b = await r.blob();
      const url = URL.createObjectURL(b);
      view.onload = () => URL.revokeObjectURL(url);
      view.src = url;
    } catch (e) { status_.textContent = 'frame error: ' + e; }
    inflight = false;
  }
  requestAnimationFrame(tick);
}

// ---- tier/status telemetry -------------------------------------------------
const telemetry = document.getElementById('telemetry');
async function pollState() {
  try {
    const s = await (await fetch('/state')).json();
    let line = `backend ${s.backend} · tier ${s.tier} · frames ${s.frames}` +
               ` · compiles ${s.compiles}`;
    if (s.tiered) {
      line += ` · static cached ${s.tiered.static_cached}` +
              ` · pending ${s.tiered.pending_compiles}` +
              ` · dyn frames ${s.tiered.dynamic_frames}`;
    }
    telemetry.textContent = line;
  } catch (e) { /* transient */ }
}
setInterval(pollState, 1000); pollState();

// ---- camera input (reference src/main.rs:58-69 routing) --------------------
function send(ev) { fetch('/event', {method:'POST', body:JSON.stringify(ev)}); }
let camdrag = null;
view.addEventListener('mousedown', e => { camdrag = e.button; e.preventDefault(); });
window.addEventListener('mouseup', () => camdrag = null);
window.addEventListener('mousemove', e => {
  if (camdrag === null) return;
  if (camdrag === 0) send({type:'orbit', dx:e.movementX, dy:e.movementY});
  else send({type:'pan', dx:e.movementX, dy:e.movementY});
});
view.addEventListener('contextmenu', e => e.preventDefault());
view.addEventListener('wheel', e => {
  e.preventDefault();
  send({type:'dolly', delta:e.deltaY});
}, {passive:false});

// ---- graph editor ----------------------------------------------------------
async function api(op) {
  const r = await fetch('/edit', {method:'POST', body:JSON.stringify(op)});
  if (!r.ok) { status_.textContent = 'edit rejected: ' + await r.text(); return null; }
  return r.json();
}
async function refresh() {
  G = await (await fetch('/graph')).json();
  draw();
}
function portEl(id, input) {
  return editor.querySelector(
    input === null ? `.outport[data-id="${id}"]`
                   : `.port[data-id="${id}"][data-input="${input}"]:not(.outport)`);
}
function portXY(el) {
  const a = el.getBoundingClientRect(), b = editor.getBoundingClientRect();
  return [a.left - b.left + a.width/2 + editor.scrollLeft,
          a.top - b.top + a.height/2 + editor.scrollTop];
}
function curve(x1, y1, x2, y2) {
  const dx = Math.max(30, Math.abs(x2 - x1) / 2);
  return `M ${x1} ${y1} C ${x1+dx} ${y1}, ${x2-dx} ${y2}, ${x2} ${y2}`;
}
function drawWires(extra) {
  wires.innerHTML = '';
  for (const n of G.nodes) {
    for (const [k, v] of Object.entries(n.inputs)) {
      if (v && typeof v === 'object' && '$node' in v) {
        const a = portEl(v['$node'], null), b = portEl(n.id, k);
        if (!a || !b) continue;
        const [x1, y1] = portXY(a), [x2, y2] = portXY(b);
        const p = document.createElementNS('http://www.w3.org/2000/svg', 'path');
        p.setAttribute('class', 'wire');
        p.setAttribute('d', curve(x1, y1, x2, y2));
        wires.appendChild(p);
      }
    }
  }
  if (extra) wires.appendChild(extra);
}
function numCell(nid, name, vals, idx, isVec) {
  const inp = document.createElement('input');
  inp.type = 'number'; inp.step = '0.1'; inp.value = vals[idx];
  inp.onchange = async () => {
    const cur = [...inp.parentElement.querySelectorAll('input')].map(x => parseFloat(x.value) || 0);
    await api({op:'set_input', id:nid, name:name, value: isVec ? cur : cur[0]});
    status_.textContent = `${name} = ${isVec ? cur : cur[0]}`;
  };
  return inp;
}
function draw() {
  editor.querySelectorAll('.node').forEach(el => el.remove());
  for (const n of G.nodes) {
    const el = document.createElement('div');
    el.className = 'node';
    const pos = (G.pos || {})[n.id] || [30, 30];
    el.style.left = pos[0] + 'px'; el.style.top = pos[1] + 'px';
    const title = document.createElement('div');
    title.className = 'title';
    title.innerHTML = `<span>${n.template}</span>`;
    const del = document.createElement('span');
    del.className = 'del'; del.textContent = '×';
    del.onclick = async () => { await api({op:'remove', id:n.id}); refresh(); };
    if (n.template !== 'Root') title.appendChild(del);
    el.appendChild(title);
    for (const spec of TPL[n.template]) {
      const row = document.createElement('div');
      row.className = 'row';
      if (spec.kind === 'sdf') {
        const port = document.createElement('div');
        port.className = 'port';
        port.dataset.id = n.id; port.dataset.input = spec.name;
        const v = n.inputs[spec.name];
        if (v && typeof v === 'object' && '$node' in v) port.classList.add('full');
        port.onclick = async () => {
          if (port.classList.contains('full')) {
            await api({op:'disconnect', dst:n.id, input:spec.name}); refresh();
          }
        };
        row.appendChild(port);
        const lab = document.createElement('label');
        lab.textContent = spec.name;
        row.appendChild(lab);
      } else {
        const lab = document.createElement('label');
        lab.textContent = spec.name;
        row.appendChild(lab);
        let v = n.inputs[spec.name];
        if (v === undefined || v === null) v = spec.default;
        const vals = Array.isArray(v) ? v : [v];
        const isVec = spec.kind === 'vec3';
        const m = isVec ? 3 : 1;
        for (let i = 0; i < m; i++)
          row.appendChild(numCell(n.id, spec.name, vals, i, isVec));
      }
      el.appendChild(row);
    }
    if (n.template !== 'Root') {
      const out = document.createElement('div');
      out.className = 'port outport full';
      out.dataset.id = n.id;
      el.appendChild(out);
    }
    editor.appendChild(el);

    // node dragging
    title.onmousedown = e => {
      if (e.target.classList.contains('del')) return;
      e.preventDefault();
      const sx = e.clientX, sy = e.clientY;
      const ox = parseFloat(el.style.left), oy = parseFloat(el.style.top);
      const move = ev => {
        el.style.left = (ox + ev.clientX - sx) + 'px';
        el.style.top = (oy + ev.clientY - sy) + 'px';
        drawWires();
      };
      const up = async ev => {
        window.removeEventListener('mousemove', move);
        window.removeEventListener('mouseup', up);
        const p = [parseFloat(el.style.left), parseFloat(el.style.top)];
        (G.pos || (G.pos = {}))[n.id] = p;
        await api({op:'move', id:n.id, pos:p});
      };
      window.addEventListener('mousemove', move);
      window.addEventListener('mouseup', up);
    };
  }
  // wire dragging from output ports
  editor.querySelectorAll('.outport').forEach(out => {
    out.onmousedown = e => {
      e.preventDefault(); e.stopPropagation();
      const src = parseInt(out.dataset.id);
      const [x1, y1] = portXY(out);
      const temp = document.createElementNS('http://www.w3.org/2000/svg', 'path');
      temp.setAttribute('class', 'wire temp');
      const move = ev => {
        const b = editor.getBoundingClientRect();
        const x2 = ev.clientX - b.left + editor.scrollLeft;
        const y2 = ev.clientY - b.top + editor.scrollTop;
        temp.setAttribute('d', curve(x1, y1, x2, y2));
        drawWires(temp);
      };
      const up = async ev => {
        window.removeEventListener('mousemove', move);
        window.removeEventListener('mouseup', up);
        const t = ev.target;
        if (t.classList && t.classList.contains('port') &&
            !t.classList.contains('outport')) {
          await api({op:'connect', src:src,
                     dst:parseInt(t.dataset.id), input:t.dataset.input});
          status_.textContent = `connected ${src} -> ${t.dataset.id}.${t.dataset.input}`;
        }
        refresh();
      };
      window.addEventListener('mousemove', move);
      window.addEventListener('mouseup', up);
    };
  });
  drawWires();
}
async function boot() {
  TPL = await (await fetch('/templates')).json();
  const sel = document.getElementById('tplsel');
  for (const name of Object.keys(TPL)) {
    if (name === 'Root') continue;
    const o = document.createElement('option');
    o.value = o.textContent = name;
    sel.appendChild(o);
  }
  document.getElementById('addnode').onclick = async () => {
    const r = await api({op:'add', template:sel.value,
                         pos:[40 + Math.random()*80, 40 + Math.random()*120]});
    if (r) { status_.textContent = `added ${sel.value} (#${r.id})`; refresh(); }
  };
  await refresh();
  tick();
}
boot();
</script></body></html>
"""


def serve(app: ViewerApp, port: int = 8000, host: str = "127.0.0.1"):
    """Serve the viewer; blocks. To embed it, build the server with
    `make_server(app, port)` and run its `serve_forever()` in a thread."""
    srv = make_server(app, port, host)
    print(
        f"raymarch_tpu_torch viewer on http://{host}:{srv.server_address[1]} "
        f"({app.width}x{app.height}, backend={app.backend})"
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


def make_server(app: ViewerApp, port: int = 0, host: str = "127.0.0.1"):
    """Build (don't start) the HTTP server wrapping `app`."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # keep the console clean
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            try:
                if path == "/":
                    self._send(200, _HTML.encode(), "text/html; charset=utf-8")
                elif path == "/frame.png":
                    self._send(200, app.frame_png(), "image/png")
                elif path == "/graph":
                    body = json.dumps(app.graph_dict()).encode()
                    self._send(200, body, "application/json")
                elif path == "/templates":
                    self._send(200, json.dumps(app.templates()).encode(),
                               "application/json")
                elif path == "/state":
                    self._send(200, json.dumps(app.state()).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:  # surface errors to the page, don't die
                self._send(500, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            try:
                data = json.loads(raw or b"{}")
                if self.path == "/event":
                    app.handle_event(data)
                    self._send(200, b"ok", "text/plain")
                elif self.path == "/graph":
                    app.set_graph(data)
                    self._send(200, b"ok", "text/plain")
                elif self.path == "/edit":
                    out = app.edit(data)
                    self._send(200, json.dumps(out).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:  # bad graphs/events are client errors
                self._send(400, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--size", default=None, help="WxH, e.g. 960x540")
    p.add_argument("--backend", default=None)
    p.add_argument("--cpu", action="store_true", help='render on the CPU with the "jnp" backend')
    p.add_argument("--aa", type=int, default=None, help="AA grid (n -> n^2 rays/px)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.size:
        w, h = (int(v) for v in args.size.lower().split("x"))
    else:
        w, h = (256, 144) if args.cpu else (960, 540)
    cfg = DEFAULT_CONFIG
    if args.aa is None and args.cpu:
        cfg = RenderConfig(aa_samples=2)  # keep the CPU interactive
    elif args.aa is not None:
        cfg = RenderConfig(aa_samples=args.aa)
    app = ViewerApp(width=w, height=h, cfg=cfg, backend=args.backend, device=device)
    app.prewarm()  # build and warm while the user opens the browser
    serve(app, port=args.port)


if __name__ == "__main__":
    main()
