"""Rendering orchestration: start/update/close the browser visualization.

Message-schema-compatible with the reference (``rendering/py/rendering.py``):
the ``init`` message carries the network operating ranges
(rendering.py:88-105) and each ``update`` message one state frame
(rendering.py:145-159), so either browser client can consume either
producer.  The client served from ``web/`` is a fresh canvas-based
implementation (no hand-drawn SVG dependency).
"""

from __future__ import annotations

import json
import os
import time
import webbrowser

from .servers import HttpServer, WsServer

WEB_FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "web")


def start(
    title, dev_type, p_max, q_max, s_rate, v_magn_min, v_magn_max, soc_max, costs_range, topology=None
):
    """Boot the HTTP + WS servers, open the browser, send the init frame
    (rendering.py:12-107).

    ``topology`` (optional, an extension over the reference schema) carries
    the true grid graph so the client can lay the scene out for *any*
    network instead of relying on a hand-drawn per-env SVG:
    ``{"busOfDevice": [bus index per device], "branches": [[f, t], ...],
    "slackBus": int}`` with bus indices in the ascending-bus-ID order used
    by ``vMagn``.  Clients that predate the field ignore it; this client
    falls back to a star/rail layout without it.

    Returns ``(http_server, ws_server)``.
    """
    from websocket import create_connection

    http_server = HttpServer(WEB_FOLDER)
    ws_server = WsServer()

    write_html(ws_server.address)

    print("\n#######################")
    print("Rendering the environment at : " + http_server.address + "/")
    print("#######################\n")

    # Poll-connect to the WS server (15 s budget; rendering.py:64-73).
    timeout = time.time() + 15
    while True:
        try:
            ws = create_connection(ws_server.address)
            break
        except ConnectionRefusedError:
            if time.time() > timeout:
                raise

    # Wait for the HTTP server, then open the browser (rendering.py:75-86).
    import requests

    timeout = time.time() + 10
    while True:
        try:
            if requests.get(http_server.address + "/").status_code == 200:
                break
        except requests.exceptions.ConnectionError:
            pass
        if time.time() > timeout:
            raise ConnectionError("Connection to HTTP server timeout.")
    webbrowser.open(http_server.address + "/")

    payload = init_payload(
        title, dev_type, p_max, q_max, s_rate, v_magn_min, v_magn_max, soc_max, costs_range, topology
    )
    message = json.dumps(payload, separators=(",", ":"))
    ws.send(message)
    ws.close()

    return http_server, ws_server


def init_payload(
    title, dev_type, p_max, q_max, s_rate, v_magn_min, v_magn_max, soc_max, costs_range, topology=None
):
    """The ``init`` message dict (schema of rendering.py:88-105), shared by
    the live WS path and the offline episode recorder (render/replay.py)."""
    payload = {
        "messageLabel": "init",
        "deviceType": list(map(int, dev_type)),
        "pMax": list(map(float, p_max)),
        "qMax": list(map(float, q_max)),
        "sRate": list(map(float, s_rate)),
        "vMagnMin": list(map(float, v_magn_min)),
        "vMagnMax": list(map(float, v_magn_max)),
        "socMax": list(map(float, soc_max)),
        "energyLossMax": float(costs_range[0]),
        "penaltyMax": float(costs_range[1]),
        "title": str(title),
    }
    if topology is not None:
        payload["topology"] = topology
    return payload


def update_payload(cur_time, year_count, p, q, s, soc, p_potential, bus_v_magn, costs, network_collapsed):
    """The ``update`` message dict (schema of rendering.py:145-159)."""
    return {
        "messageLabel": "update",
        "time": [cur_time.month, cur_time.day, cur_time.hour, cur_time.minute],
        "yearCount": int(year_count),
        "pInjections": list(map(float, p)),
        "qInjections": list(map(float, q)),
        "sFlows": list(map(float, s)),
        "socStorage": list(map(float, soc)),
        "pPotential": list(map(float, p_potential)),
        "vMagn": list(map(float, bus_v_magn)),
        "reward": list(map(float, costs)),
        "networkCollapsed": bool(network_collapsed),
    }


def update(ws_address, cur_time, year_count, p, q, s, soc, p_potential, bus_v_magn, costs, network_collapsed):
    """Push one state frame over a fresh WS connection (rendering.py:110-165)."""
    from websocket import create_connection

    ws = create_connection(ws_address)
    message = json.dumps(
        update_payload(cur_time, year_count, p, q, s, soc, p_potential, bus_v_magn, costs, network_collapsed)
    )
    ws.send(message)
    ws.close()


def close(http_server, ws_server):
    """Terminate both server processes (rendering.py:168-181)."""
    http_server.process.terminate()
    ws_server.process.terminate()


def write_html(ws_address):
    """Point the served page at the current WS address (rendering.py:184-223)."""
    html = """<!DOCTYPE html>
<html>
<head>
    <meta charset="utf-8">
    <link rel="stylesheet" href="styles.css">
    <script>var wsServerAddress = "{addr}";</script>
    <script src="app.js" defer></script>
    <title>gym-anm-tpu</title>
</head>
<body>
    <header><h1 id="title">gym-anm-tpu</h1><span id="clock"></span></header>
    <main>
        <div id="scene-wrap">
            <svg id="network" width="980" height="600"></svg>
            <div id="collapse-overlay" hidden><span>NETWORK COLLAPSED</span></div>
        </div>
        <div id="reward-panel">
            <div class="bar-label">Energy loss <span id="eloss-val" class="bar-val"></span></div>
            <div class="bar"><div id="eloss-bar" class="bar-fill"></div></div>
            <div class="bar-label">Penalty <span id="penalty-val" class="bar-val"></span></div>
            <div class="bar"><div id="penalty-bar" class="bar-fill penalty"></div></div>
            <div id="legend"></div>
            <div id="collapse-banner" hidden>NETWORK COLLAPSED</div>
        </div>
    </main>
</body>
</html>
""".format(addr=ws_address)
    with open(os.path.join(WEB_FOLDER, "index.html"), "w") as f:
        f.write(html)
