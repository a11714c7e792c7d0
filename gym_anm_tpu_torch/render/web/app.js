/* gym-anm-tpu browser visualization.
 *
 * An SVG renderer for the ANM rendering protocol: consumes the same
 * init/update JSON messages as the reference client (init.js:28-89) but
 * builds the whole scene procedurally.  When the init message carries the
 * optional "topology" extension ({busOfDevice, branches, slackBus}) the
 * true grid graph is laid out as a tidy tree from the slack bus -- so any
 * network renders correctly, not just a hand-drawn one; without it the
 * client falls back to a star/rail layout.
 *
 * Scene per frame: busbars with voltage readouts (red on limit violation),
 * branches shaded by loading with animated flow dashes and |S|/rate labels,
 * device icons (grid/house/generator/renewable/battery) with signed P bars,
 * curtailment ticks on renewables, battery state-of-charge fill, and the
 * energy-loss / penalty bars of the reward signal.
 */
"use strict";

const SVGNS = "http://www.w3.org/2000/svg";
const DEV_NAMES = { "-1": "load", 0: "grid", 1: "gen", 2: "RES", 3: "storage" };

const COL = {
  bus: "#2c3e50",
  busBad: "#e74c3c",
  wire: "#95a5a6",
  text: "#2c3e50",
  subtext: "#7f8c8d",
  load: "#7f8c8d",
  gen: "#8e44ad",
  res: "#27ae60",
  storage: "#2980b9",
  slack: "#2c3e50",
  pPos: "#27ae60",
  pNeg: "#c0392b",
  qBar: "#f39c12",
  gauge: "#e5e8ea",
  potential: "#f39c12",
};

let spec = null; // init message
let frame = null; // latest update message
let scene = null; // element handles built once from spec
let dashPhase = 0;

/* ------------------------------------------------------------------ */
/* WebSocket plumbing                                                  */
/* ------------------------------------------------------------------ */
function handleMessage(msg) {
  if (msg.messageLabel === "init") {
    spec = msg;
    document.getElementById("title").textContent = msg.title;
    buildScene();
  } else if (msg.messageLabel === "update" && spec !== null) {
    frame = msg;
    applyFrame(msg); // drives the scene, clock and reward bars
  }
}

function connect() {
  const ws = new WebSocket(wsServerAddress);
  ws.onmessage = (ev) => handleMessage(JSON.parse(ev.data));
  ws.onclose = () => setTimeout(connect, 1000);
}

/* Offline replay: a recorded episode is embedded as `REPLAY` ({init,
 * frames}) in a standalone HTML file (render/replay.py) -- no servers, no
 * WebSocket.  A timeline slider + play/pause drive handleMessage. */
function setupReplay(data) {
  handleMessage(data.init);
  const n = data.frames.length;
  const bar = document.createElement("div");
  bar.id = "replay-bar";
  bar.innerHTML =
    '<button id="replay-play">&#9654;</button>' +
    '<input id="replay-slider" type="range" min="0" max="' + Math.max(n - 1, 0) + '" value="0">' +
    '<span id="replay-pos">1 / ' + n + "</span>";
  document.body.appendChild(bar);
  const slider = document.getElementById("replay-slider");
  const pos = document.getElementById("replay-pos");
  const play = document.getElementById("replay-play");
  let timer = null;
  function show(i) {
    i = Math.max(0, Math.min(n - 1, i | 0));
    slider.value = String(i);
    pos.textContent = (i + 1) + " / " + n;
    if (n > 0) handleMessage(data.frames[i]);
  }
  slider.addEventListener("input", () => {
    stop();
    show(Number(slider.value));
  });
  function stop() {
    if (timer !== null) { clearInterval(timer); timer = null; play.innerHTML = "&#9654;"; }
  }
  play.addEventListener("click", () => {
    if (timer !== null) { stop(); return; }
    play.innerHTML = "&#10074;&#10074;";
    timer = setInterval(() => {
      const i = Number(slider.value);
      if (i >= n - 1) { stop(); return; }
      show(i + 1);
    }, data.intervalMs || 500);
  });
  show(0);
}

/* ------------------------------------------------------------------ */
/* Topology + layout                                                   */
/* ------------------------------------------------------------------ */
function topologyOf(spec) {
  const nBus = spec.vMagnMin.length;
  if (spec.topology) return spec.topology;
  // Fallback (no topology in init): star from bus 0 + rail, round-robin
  // devices over the non-slack buses.
  const branches = [];
  for (let i = 1; i < nBus && branches.length < spec.sRate.length; i++) branches.push([0, i]);
  for (let i = 1; i + 1 < nBus && branches.length < spec.sRate.length; i++) branches.push([i, i + 1]);
  const busOfDevice = [];
  let rr = 0;
  for (const t of spec.deviceType) {
    if (t === 0) busOfDevice.push(0);
    else busOfDevice.push(1 + (rr++ % Math.max(1, nBus - 1)));
  }
  return { busOfDevice, branches, slackBus: 0 };
}

/* Tidy tree layout: BFS tree from the slack bus; a node's width is
 * max(its device row, sum of its children); leaves pack left-to-right.
 * Non-tree (loop-closing) branches render as dashed arcs. */
function layout(spec, topo) {
  const nBus = spec.vMagnMin.length;
  const devsOfBus = Array.from({ length: nBus }, () => []);
  topo.busOfDevice.forEach((b, d) => devsOfBus[b].push(d));

  const adj = Array.from({ length: nBus }, () => []);
  topo.branches.forEach(([f, t], k) => {
    adj[f].push([t, k]);
    adj[t].push([f, k]);
  });

  const parent = new Array(nBus).fill(-1);
  const depth = new Array(nBus).fill(-1);
  const children = Array.from({ length: nBus }, () => []);
  const treeEdge = new Array(topo.branches.length).fill(false);
  const order = [];
  depth[topo.slackBus] = 0;
  const queue = [topo.slackBus];
  while (queue.length) {
    const u = queue.shift();
    order.push(u);
    for (const [v, k] of adj[u]) {
      if (depth[v] === -1) {
        depth[v] = depth[u] + 1;
        parent[v] = u;
        children[u].push(v);
        treeEdge[k] = true;
        queue.push(v);
      }
    }
  }
  // Disconnected buses (shouldn't happen on valid specs): park them at depth 1.
  for (let i = 0; i < nBus; i++) if (depth[i] === -1) { depth[i] = 1; order.push(i); }

  const DEV_W = 64; // width per device column
  const BUS_MIN_W = 56;
  const GAP = 26;
  const LEVEL_H = 168;

  const width = new Array(nBus).fill(0);
  for (let i = order.length - 1; i >= 0; i--) {
    const u = order[i];
    const own = Math.max(BUS_MIN_W, devsOfBus[u].length * DEV_W);
    const kids = children[u].reduce((s, c) => s + width[c], 0) + GAP * Math.max(0, children[u].length - 1);
    width[u] = Math.max(own, kids);
  }
  const x = new Array(nBus).fill(0);
  const y = new Array(nBus).fill(0);
  const placeAt = (u, left) => {
    x[u] = left + width[u] / 2;
    y[u] = 64 + depth[u] * LEVEL_H;
    let cl = left + (width[u] - (children[u].reduce((s, c) => s + width[c], 0) + GAP * Math.max(0, children[u].length - 1))) / 2;
    for (const c of children[u]) {
      placeAt(c, cl);
      cl += width[c] + GAP;
    }
  };
  placeAt(topo.slackBus, 24);
  // Any parked disconnected buses: shove to the right of the tree.
  let rightEdge = 24 + width[topo.slackBus] + GAP;
  for (let i = 0; i < nBus; i++) {
    if (parent[i] === -1 && i !== topo.slackBus) {
      x[i] = rightEdge + width[i] / 2;
      y[i] = 64 + depth[i] * LEVEL_H;
      rightEdge += width[i] + GAP;
    }
  }

  const maxDepth = Math.max(...depth);
  return {
    devsOfBus,
    x,
    y,
    busW: (u) => Math.max(BUS_MIN_W, devsOfBus[u].length * DEV_W),
    treeEdge,
    W: Math.max(rightEdge + 24, 640),
    H: 64 + (maxDepth + 1) * LEVEL_H + 36,
    DEV_W,
  };
}

/* ------------------------------------------------------------------ */
/* SVG helpers                                                         */
/* ------------------------------------------------------------------ */
function el(tag, attrs, parent) {
  const e = document.createElementNS(SVGNS, tag);
  for (const k in attrs) e.setAttribute(k, attrs[k]);
  if (parent) parent.appendChild(e);
  return e;
}

function txt(parent, x, y, s, size, fill, anchor) {
  const t = el(
    "text",
    { x, y, "font-size": size || 11, fill: fill || COL.text, "text-anchor": anchor || "middle" },
    parent
  );
  t.textContent = s;
  return t;
}

function loadColor(frac) {
  if (!isFinite(frac)) frac = 0;
  const f = Math.max(0, Math.min(1, frac));
  const r = Math.round(46 + f * (231 - 46));
  const g = Math.round(204 - f * (204 - 76));
  const b = Math.round(113 - f * (113 - 60));
  return `rgb(${r},${g},${b})`;
}

/* Device icons, drawn in a 28x28 box centered on (0, 0). */
function drawIcon(g, type) {
  if (type === 0) {
    // External grid: pylon triangle + crossarms.
    el("path", { d: "M -9 12 L 0 -12 L 9 12 Z", fill: "none", stroke: COL.slack, "stroke-width": 2 }, g);
    el("line", { x1: -11, y1: -4, x2: 11, y2: -4, stroke: COL.slack, "stroke-width": 2 }, g);
    el("line", { x1: -8, y1: 3, x2: 8, y2: 3, stroke: COL.slack, "stroke-width": 2 }, g);
  } else if (type === -1) {
    // Load: house.
    el("path", { d: "M -10 0 L 0 -11 L 10 0 Z", fill: COL.load }, g);
    el("rect", { x: -7, y: 0, width: 14, height: 11, fill: COL.load }, g);
    el("rect", { x: -2, y: 4, width: 4, height: 7, fill: "#fff" }, g);
  } else if (type === 1) {
    // Classical generator: circle with a sine wave.
    el("circle", { cx: 0, cy: 0, r: 11, fill: "none", stroke: COL.gen, "stroke-width": 2.5 }, g);
    el("path", { d: "M -6 0 Q -3 -7 0 0 T 6 0", fill: "none", stroke: COL.gen, "stroke-width": 2 }, g);
  } else if (type === 2) {
    // Renewable: sun (circle + rays).
    el("circle", { cx: 0, cy: 0, r: 6, fill: COL.res }, g);
    for (let i = 0; i < 8; i++) {
      const a = (i * Math.PI) / 4;
      el(
        "line",
        {
          x1: 8.5 * Math.cos(a), y1: 8.5 * Math.sin(a),
          x2: 12 * Math.cos(a), y2: 12 * Math.sin(a),
          stroke: COL.res, "stroke-width": 2, "stroke-linecap": "round",
        },
        g
      );
    }
  } else if (type === 3) {
    // Battery shell; the SoC fill is a separate dynamic rect.
    el("rect", { x: -9, y: -11, width: 18, height: 22, rx: 2, fill: "none", stroke: COL.storage, "stroke-width": 2 }, g);
    el("rect", { x: -4, y: -14, width: 8, height: 3, fill: COL.storage }, g);
  }
}

/* ------------------------------------------------------------------ */
/* Scene construction (once per init)                                  */
/* ------------------------------------------------------------------ */
function buildScene() {
  const svg = document.getElementById("network");
  svg.innerHTML = "";
  const topo = topologyOf(spec);
  const L = layout(spec, topo);
  svg.setAttribute("viewBox", `0 0 ${L.W} ${L.H}`);
  svg.setAttribute("width", Math.min(1180, L.W));
  svg.setAttribute("height", Math.min(760, L.H));

  const gBranches = el("g", {}, svg);
  const gBuses = el("g", {}, svg);
  const gDevs = el("g", {}, svg);

  scene = { branches: [], buses: [], devices: [], topo, L };

  // Branches.
  topo.branches.forEach(([f, t], k) => {
    const x1 = L.x[f], y1 = L.y[f], x2 = L.x[t], y2 = L.y[t];
    let d;
    if (L.treeEdge[k]) {
      d = `M ${x1} ${y1} L ${x1} ${(y1 + y2) / 2} L ${x2} ${(y1 + y2) / 2} L ${x2} ${y2}`;
    } else {
      // Loop-closing edge: arc around the tree.
      const mx = (x1 + x2) / 2 + 40, my = (y1 + y2) / 2;
      d = `M ${x1} ${y1} Q ${mx} ${my} ${x2} ${y2}`;
    }
    const base = el("path", { d, fill: "none", stroke: "#d5dbdd", "stroke-width": 5 }, gBranches);
    const flow = el(
      "path",
      { d, fill: "none", stroke: COL.wire, "stroke-width": 3, "stroke-dasharray": "7 7" },
      gBranches
    );
    const lbl = txt(gBranches, (x1 + x2) / 2 + 6, (y1 + y2) / 2 - 6, "", 10, COL.subtext, "start");
    scene.branches.push({ base, flow, lbl, len: base.getTotalLength ? base.getTotalLength() : 100 });
  });

  // Buses.
  for (let i = 0; i < L.x.length; i++) {
    const w = L.busW(i);
    const bar = el(
      "rect",
      { x: L.x[i] - w / 2, y: L.y[i] - 3, width: w, height: 6, rx: 3, fill: COL.bus },
      gBuses
    );
    txt(gBuses, L.x[i] - w / 2 - 6, L.y[i] + 4, `B${i}`, 11, COL.subtext, "end");
    const vLbl = txt(gBuses, L.x[i] + w / 2 + 6, L.y[i] + 4, "", 11, COL.text, "start");
    scene.buses.push({ bar, vLbl });
  }

  // Devices: a row under their bus.
  for (let i = 0; i < L.x.length; i++) {
    const devs = L.devsOfBus[i];
    devs.forEach((d, j) => {
      const cx = L.x[i] - (devs.length * L.DEV_W) / 2 + L.DEV_W * (j + 0.5);
      const type = spec.deviceType[d];
      const topY = L.y[i] + 3;
      const iconY = L.y[i] + 42;
      el("line", { x1: cx, y1: topY, x2: cx, y2: iconY - 16, stroke: COL.wire, "stroke-width": 1.5 }, gDevs);
      const g = el("g", { transform: `translate(${cx}, ${iconY})` }, gDevs);
      drawIcon(g, type);
      const name = txt(gDevs, cx, iconY + 24, `${DEV_NAMES[type]} ${d}`, 9.5, COL.subtext);

      // Gauges under the icon: signed P bar (+ potential tick), SoC fill.
      const gw = 48;
      const gy = iconY + 30;
      el("rect", { x: cx - gw / 2, y: gy, width: gw, height: 6, rx: 2, fill: COL.gauge }, gDevs);
      el("line", { x1: cx, y1: gy - 1, x2: cx, y2: gy + 7, stroke: "#b7bec1", "stroke-width": 1 }, gDevs);
      const pBar = el("rect", { x: cx, y: gy, width: 0, height: 6, fill: COL.pPos }, gDevs);
      const pLbl = txt(gDevs, cx, gy + 17, "", 9.5, COL.text);
      let potTick = null;
      let socFill = null;
      if (type === 1 || type === 2) {
        potTick = el("line", { x1: cx, y1: gy - 2, x2: cx, y2: gy + 8, stroke: COL.potential, "stroke-width": 2 }, gDevs);
      }
      if (type === 3) {
        // Fill inside the battery shell drawn at (cx-9, iconY-11), 18x22.
        socFill = el("rect", { x: cx - 7, y: iconY + 9, width: 14, height: 0, fill: COL.storage, opacity: 0.85 }, gDevs);
      }
      scene.devices.push({ d, type, cx, gy, gw, pBar, pLbl, potTick, socFill, iconY });
    });
  }
  // Index maps for update vectors: pPotential is over non-slack generators
  // (types 1 and 2) in device order; socStorage over type-3 devices.
  let gi = 0, si = 0;
  const genIndex = {}, socIndex = {};
  spec.deviceType.forEach((t, d) => {
    if (t === 1 || t === 2) genIndex[d] = gi++;
    if (t === 3) socIndex[d] = si++;
  });
  scene.genIndex = genIndex;
  scene.socIndex = socIndex;

  buildLegend();
  if (frame) applyFrame(frame);
}

function buildLegend() {
  const box = document.getElementById("legend");
  box.innerHTML = "<div class='bar-label'>Legend</div>";
  const rows = [
    ["grid (slack)", COL.slack],
    ["load", COL.load],
    ["generator", COL.gen],
    ["renewable", COL.res],
    ["storage", COL.storage],
    ["potential / curtailment", COL.potential],
  ];
  for (const [name, color] of rows) {
    const r = document.createElement("div");
    r.className = "legend-row";
    r.innerHTML = `<span class="legend-dot" style="background:${color}"></span>${name}`;
    box.appendChild(r);
  }
}

/* ------------------------------------------------------------------ */
/* Frame application                                                   */
/* ------------------------------------------------------------------ */
/* Pure frame -> SVG-attribute computation.  No DOM access: everything the
 * update path decides (colors, geometry, labels, visibility) is computed
 * here from (spec, scene geometry, update msg) into plain data, and
 * applyFrame below only copies it onto the elements.  This function's
 * source is PINNED byte-for-byte by tests/test_replay_artifact.py, which
 * also runs a line-by-line Python mirror of it on the committed replay
 * payload: changing the logic here without updating the mirror (and the
 * pinned copy in tests/data/frame_attrs_pinned.js) fails the suite. */
function frameAttrs(spec, scene, msg) {
  const out = { branches: [], buses: [], devices: [], reward: null, clock: null };

  // Branches: loading color, |S|/rate label, dash direction.
  msg.sFlows.forEach((s, k) => {
    const mag = Math.abs(s);
    const rate = spec.sRate[k];
    const frac = rate > 0 && isFinite(rate) ? mag / rate : 0;
    out.branches.push({
      stroke: loadColor(frac),
      strokeWidth: frac > 1 ? 4.5 : 3,
      label: isFinite(rate) ? `${mag.toFixed(1)}/${rate.toFixed(0)} MVA` : `${mag.toFixed(1)} MVA`,
      dir: s >= 0 ? 1 : -1,
      speed: Math.min(3, 0.4 + 2.6 * frac),
    });
  });

  // Buses: voltage readout, red when out of bounds.
  msg.vMagn.forEach((v, i) => {
    const bad = v < spec.vMagnMin[i] - 1e-9 || v > spec.vMagnMax[i] + 1e-9;
    out.buses.push({
      fill: bad ? COL.busBad : COL.bus,
      text: `${v.toFixed(3)} pu`,
      textFill: bad ? COL.busBad : COL.text,
    });
  });

  // Devices: P bar, labels, curtailment tick, SoC fill.
  for (const dv of scene.devices) {
    const p = msg.pInjections[dv.d];
    const q = msg.qInjections[dv.d];
    const pmax = spec.pMax[dv.d];
    const frac = pmax > 0 && isFinite(pmax) ? Math.max(-1, Math.min(1, p / pmax)) : 0;
    const w = (Math.abs(frac) * dv.gw) / 2;
    const a = {
      d: dv.d,
      barX: frac >= 0 ? dv.cx : dv.cx - w,
      barW: w,
      barFill: frac >= 0 ? COL.pPos : COL.pNeg,
      label: `${p.toFixed(1)} MW / ${q.toFixed(1)} MVAr`,
      pot: null,
      soc: null,
    };
    if (dv.potTick && dv.type === 2) {
      const pot = msg.pPotential[scene.genIndex[dv.d]];
      if (isFinite(pot) && pmax > 0) {
        const px = dv.cx + (Math.max(-1, Math.min(1, pot / pmax)) * dv.gw) / 2;
        a.pot = { x: px, visible: true };
      } else {
        a.pot = { x: dv.cx, visible: false };
      }
    } else if (dv.potTick) {
      a.pot = { x: dv.cx, visible: false };
    }
    if (dv.socFill) {
      const soc = msg.socStorage[scene.socIndex[dv.d]];
      const maxSoc = spec.socMax[scene.socIndex[dv.d]];
      const f = maxSoc > 0 ? Math.max(0, Math.min(1, soc / maxSoc)) : 0;
      const h = 18 * f;
      a.soc = { height: h, y: dv.iconY + 9 - h };
    }
    out.devices.push(a);
  }

  // Reward bars + collapse banner (updateReward's decisions).
  const [eloss, penalty] = msg.reward;
  out.reward = {
    elossPct: Math.min(100, (100 * Math.abs(eloss)) / spec.energyLossMax),
    penaltyPct: Math.min(100, (100 * penalty) / spec.penaltyMax),
    elossText: eloss.toFixed(3),
    penaltyText: penalty.toFixed(3),
    collapsed: !!msg.networkCollapsed,
  };

  // Clock readout (updateClock's string).
  const [month, day, hour, minute] = msg.time;
  const pad = (x) => String(x).padStart(2, "0");
  let clock = `${pad(day)}/${pad(month)} ${pad(hour)}:${pad(minute)}`;
  if (msg.yearCount > 0) clock += `  (+${msg.yearCount}y)`;
  out.clock = clock;

  return out;
}

function applyFrame(msg) {
  if (!scene) return;
  const fa = frameAttrs(spec, scene, msg);

  fa.branches.forEach((a, k) => {
    const br = scene.branches[k];
    br.flow.setAttribute("stroke", a.stroke);
    br.flow.setAttribute("stroke-width", a.strokeWidth);
    br.lbl.textContent = a.label;
    br.dir = a.dir;
    br.speed = a.speed;
  });

  fa.buses.forEach((a, i) => {
    const b = scene.buses[i];
    b.bar.setAttribute("fill", a.fill);
    b.vLbl.textContent = a.text;
    b.vLbl.setAttribute("fill", a.textFill);
  });

  fa.devices.forEach((a, j) => {
    const dv = scene.devices[j];
    dv.pBar.setAttribute("x", a.barX);
    dv.pBar.setAttribute("width", a.barW);
    dv.pBar.setAttribute("fill", a.barFill);
    dv.pLbl.textContent = a.label;
    if (a.pot && dv.potTick) {
      dv.potTick.setAttribute("x1", a.pot.x);
      dv.potTick.setAttribute("x2", a.pot.x);
      dv.potTick.setAttribute("visibility", a.pot.visible ? "visible" : "hidden");
    }
    if (a.soc && dv.socFill) {
      dv.socFill.setAttribute("height", a.soc.height);
      dv.socFill.setAttribute("y", a.soc.y);
    }
  });

  document.getElementById("clock").textContent = fa.clock;
  document.getElementById("eloss-bar").style.width = fa.reward.elossPct + "%";
  document.getElementById("penalty-bar").style.width = fa.reward.penaltyPct + "%";
  document.getElementById("eloss-val").textContent = fa.reward.elossText;
  document.getElementById("penalty-val").textContent = fa.reward.penaltyText;
  document.getElementById("collapse-banner").hidden = !fa.reward.collapsed;
  document.getElementById("collapse-overlay").hidden = !fa.reward.collapsed;
}

/* Dash animation: offset moves along the flow direction, faster when the
 * branch is more loaded. */
function tick() {
  dashPhase += 1;
  if (scene) {
    for (const br of scene.branches) {
      const dir = br.dir || 1;
      const speed = br.speed || 0.5;
      br.flow.setAttribute("stroke-dashoffset", String((-dashPhase * speed * dir) % 14));
    }
  }
  requestAnimationFrame(tick);
}

if (typeof REPLAY !== "undefined") {
  setupReplay(REPLAY);
} else {
  connect();
}
requestAnimationFrame(tick);
