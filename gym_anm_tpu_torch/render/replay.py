"""Offline episode replay: record frames, write one self-contained HTML file.

The live rendering stack (HTTP + WebSocket servers + browser, following the
reference design, rendering/py/rendering.py:12-165) requires a running
Python process.  The recorder below captures the exact same ``init`` /
``update`` message stream and embeds it — together with the client JS/CSS —
into a single HTML file with a timeline slider and play/pause controls.
The file needs no server and no Python: open it in any browser, attach it
to a report, or archive it next to a training run.

Usage (via :class:`~gym_anm_tpu_torch.envs.anm_env.ANMEnv`)::

    env = ANM6Easy(device="cpu")
    env.reset(seed=0)
    env.render(mode="replay")          # starts recording, no servers
    for _ in range(96):
        env.step(agent.act(env))
        env.render()                   # records one frame
    env.write_replay("episode.html")   # standalone artifact
"""

from __future__ import annotations

import json
import os

from .rendering import init_payload, update_payload

WEB_FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "web")


class EpisodeRecorder:
    """Accumulates one episode's rendering messages in memory."""

    def __init__(
        self,
        title,
        dev_type,
        p_max,
        q_max,
        s_rate,
        v_magn_min,
        v_magn_max,
        soc_max,
        costs_range,
        topology=None,
        interval_ms: int = 500,
    ):
        self.init = init_payload(
            title, dev_type, p_max, q_max, s_rate, v_magn_min, v_magn_max, soc_max, costs_range, topology
        )
        self.frames: list[dict] = []
        self.interval_ms = int(interval_ms)

    def frame(self, cur_time, year_count, p, q, s, soc, p_potential, bus_v_magn, costs, network_collapsed):
        """Record one state frame (same signature as rendering.update without
        the WS address)."""
        self.frames.append(
            update_payload(cur_time, year_count, p, q, s, soc, p_potential, bus_v_magn, costs, network_collapsed)
        )

    # ------------------------------------------------------------------
    def to_html(self) -> str:
        """Render the standalone replay page (inlined CSS/JS + data)."""
        with open(os.path.join(WEB_FOLDER, "styles.css")) as f:
            css = f.read()
        with open(os.path.join(WEB_FOLDER, "app.js")) as f:
            js = f.read()
        data = json.dumps(
            {"init": self.init, "frames": self.frames, "intervalMs": self.interval_ms},
            separators=(",", ":"),
        )
        # "</script>" inside JSON strings would terminate the script block.
        data = data.replace("</", "<\\/")
        title = self.init.get("title", "gym-anm-tpu replay")
        return f"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<style>
{css}
#replay-bar {{ position: fixed; bottom: 0; left: 0; right: 0; display: flex;
  gap: 12px; align-items: center; padding: 8px 16px; background: #1c2330;
  color: #dce3f0; font: 13px system-ui, sans-serif; }}
#replay-bar input[type=range] {{ flex: 1; }}
#replay-bar button {{ min-width: 36px; }}
</style>
<title>{title} — replay</title>
</head>
<body>
<header><h1 id="title">{title}</h1><span id="clock"></span></header>
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
<script>var REPLAY = {data};</script>
<script>
{js}
</script>
</body>
</html>
"""

    def write(self, path: str) -> str:
        """Write the replay HTML to ``path``; returns the absolute path."""
        path = os.path.abspath(path)
        with open(path, "w") as f:
            f.write(self.to_html())
        return path
