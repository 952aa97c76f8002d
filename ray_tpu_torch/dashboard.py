"""Dashboard: HTTP UI + JSON API over the cluster's state. Ported from
``ray_tpu/dashboard.py``.

Role parity: dashboard/head.py:71 (the head-side dashboard server: REST
endpoints for nodes/actors/jobs + static UI) — re-scoped: no
React bundle or per-node agent processes (the node daemon already serves
the per-node surface the reference's dashboard agent provides,
dashboard/agent.py:66), just a dependency-free threaded HTTP server the
head starts next to the conductor.

Endpoints:
    /                  one-page HTML overview (auto-refreshing)
    /api/cluster       totals + per-node resources
    /api/nodes         node table
    /api/actors        actor table
    /api/jobs          job table (submission records from the KV)
    /api/tasks         recent task events
    /api/placement_groups
    /api/objects       per-node object-store stats
    /metrics           Prometheus text (util/metrics.py exposition)
"""

from __future__ import annotations

import json
import pickle
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from ray_tpu_torch.cluster.protocol import get_client
from ray_tpu_torch.state import api as state_api

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<meta http-equiv="refresh" content="5">
<style>
body{font-family:system-ui,sans-serif;margin:24px;background:#fafafa}
h1{font-size:20px} h2{font-size:15px;margin-top:28px}
table{border-collapse:collapse;font-size:13px;min-width:480px}
td,th{border:1px solid #ddd;padding:4px 10px;text-align:left}
th{background:#f0f0f0} .ALIVE{color:#0a7d32} .DEAD,.FAILED{color:#b00020}
</style></head><body>
<h1>ray_tpu_torch cluster</h1><div id=c>loading…</div>
<script>
async function j(p){return (await fetch(p)).json()}
(async()=>{
 const [cl,no,ac,jo,dbg]=await Promise.all(
   [j('/api/cluster'),j('/api/nodes'),j('/api/actors'),j('/api/jobs'),
    j('/api/debug').catch(()=>({nodes:{}}))]);
 let h=`<h2>Resources</h2><table><tr><th>resource</th><th>available</th>
 <th>total</th></tr>`;
 for(const k of Object.keys(cl.total))
   h+=`<tr><td>${k}</td><td>${cl.available[k]??0}</td>
   <td>${cl.total[k]}</td></tr>`;
 h+=`</table><h2>Nodes (${no.length})</h2><table><tr><th>node</th>
 <th>state</th><th>head</th><th>address</th><th>resources</th>
 <th>debug</th><th>workers (profile)</th></tr>`;
 for(const n of no){
   const d=(dbg.nodes||{})[n.node_id]||{};
   const pids=(d.worker_pids||[]).map(p=>
     `<a href=/api/profile/${n.node_id}/${p}?duration=2>${p}</a>`).join(' ');
   h+=`<tr><td>${n.node_id.slice(0,12)}</td>
 <td class=${n.state}>${n.state}</td><td>${n.is_head_node?'✓':''}</td>
 <td>${n.address}</td><td>${JSON.stringify(n.resources_total)}</td>
 <td><a href=/api/debug/${n.node_id}>state</a></td><td>${pids}</td></tr>`;}
 h+=`</table><h2>Actors (${ac.length})</h2><table><tr><th>actor</th>
 <th>class</th><th>name</th><th>state</th><th>restarts</th></tr>`;
 for(const a of ac) h+=`<tr><td>${a.actor_id.slice(0,12)}</td>
 <td>${a.class_name}</td><td>${a.name||''}</td>
 <td class=${a.state}>${a.state}</td><td>${a.num_restarts}</td></tr>`;
 h+=`</table><h2>Jobs (${jo.length})</h2><table><tr><th>id</th>
 <th>status</th><th>entrypoint</th></tr>`;
 for(const x of jo) h+=`<tr><td>${x.submission_id}</td>
 <td class=${x.status}>${x.status}</td><td>${x.entrypoint}</td></tr>`;
 document.getElementById('c').innerHTML=h+'</table>';
})();
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # silence per-request stderr noise
        pass

    def _send(self, body: bytes, ctype: str = "application/json",
              code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj: Any) -> None:
        self._send(json.dumps(obj, default=str).encode())

    def do_GET(self):  # noqa: N802 - http.server API
        dash: "Dashboard" = self.server.dashboard  # type: ignore[attr-defined]
        try:
            path = self.path.split("?")[0].rstrip("/") or "/"
            if path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif path == "/api/cluster":
                self._json(dash.cluster())
            elif path == "/api/nodes":
                self._json(dash.nodes())
            elif path == "/api/actors":
                self._json(dash.actors())
            elif path == "/api/jobs":
                self._json(dash.jobs())
            elif path == "/api/tasks":
                self._json(dash.tasks())
            elif path == "/api/placement_groups":
                self._json(dash.placement_groups())
            elif path == "/api/objects":
                self._json(dash.objects())
            elif path == "/api/events":
                self._json(dash.events())
            elif path == "/api/spans":
                self._json(dash.spans())
            elif path == "/api/ring":
                self._json(dash.ring())
            elif path == "/api/debug":
                self._json(dash.debug())
            elif path.startswith("/api/debug/"):
                # /api/debug/<node_hex> -> that node's daemon debug_state
                self._json(dash.debug(path.rsplit("/", 1)[-1]))
            elif path.startswith("/api/profile/"):
                # /api/profile/<pid>?duration=2            (any node)
                # /api/profile/<node_hex>/<pid>?duration=2 (scoped)
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                dur = float(q.get("duration", ["2.0"])[0])
                seg = path[len("/api/profile/"):].split("/")
                node_hex = seg[0] if len(seg) > 1 else None
                self._send(dash.profile(int(seg[-1]), dur,
                                        node_hex=node_hex).encode(),
                           "text/plain")
            elif path == "/metrics":
                from ray_tpu_torch.util.metrics import prometheus_text
                self._send(prometheus_text().encode(), "text/plain")
            else:
                self._send(b'{"error": "not found"}', code=404)
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 - surfaced as a 500
            try:
                self._send(json.dumps({"error": repr(e)}).encode(), code=500)
            except OSError:
                pass


class Dashboard:
    """Serves the UI/API backed by conductor + daemon RPCs."""

    def __init__(self, conductor_address: str, host: str = "127.0.0.1",
                 port: int = 0):
        self._cli = get_client(conductor_address)
        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self._srv.dashboard = self  # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name="rt-torch-dashboard")
        self._thread.start()

    # -- data providers -------------------------------------------------
    def cluster(self) -> dict:
        return {"total": self._cli.call("cluster_resources"),
                "available": self._cli.call("available_resources")}

    def nodes(self) -> list:
        return state_api.node_rows(self._cli)

    def actors(self) -> list:
        return self._cli.call("list_actors")

    def jobs(self) -> list:
        out = []
        for key in self._cli.call("kv_keys", ns="_jobs"):
            blob = self._cli.call("kv_get", ns="_jobs", key=key)
            if blob is not None:
                out.append(pickle.loads(blob))
        return sorted(out, key=lambda r: r.get("submit_time", 0))

    def tasks(self, limit: int = 500) -> list:
        return self._cli.call("get_task_events")[-limit:]

    def placement_groups(self) -> list:
        return self._cli.call("list_placement_groups")

    def events(self, limit: int = 500) -> list:
        return self._cli.call("list_events", limit=limit)

    def spans(self) -> list:
        # Spans ship via the background event flusher; flush this
        # process's tail first so a head-side dashboard read sees its
        # own just-recorded spans (read-your-writes, timeline() parity).
        try:
            from ray_tpu_torch.util import events as _events
            _events.flush_now()
        except Exception:
            pass
        return self._cli.call("get_spans")

    def profile(self, pid: int, duration_s: float = 2.0,
                node_hex: Optional[str] = None) -> str:
        """Collapsed-stack profile of the worker with this OS pid.
        ``node_hex`` (a node-id hex prefix) scopes the probe to one node:
        pids are per-host, so on a multi-host cluster an unscoped probe
        can profile a DIFFERENT node's coincidentally-same pid."""
        dump = state_api.profile_on(self._cli, pid, duration_s,
                                    node_id=node_hex)
        if dump is None:
            where = f" on node {node_hex}" if node_hex else ""
            return f"no live worker with pid {pid}{where}"
        return dump

    def ring(self, limit: int = 1000) -> list:
        """Recent flight-recorder events (conductor ring store)."""
        return self._cli.call("get_ring_events", limit=limit)

    def debug(self, node_hex: Optional[str] = None) -> dict:
        """Cluster debug-state dump (debug_state.txt role): conductor
        tables plus per-node daemon tables; ``node_hex`` narrows to one
        node's daemon."""
        if node_hex:
            for n in self._cli.call("get_nodes"):
                if n["node_id"].hex().startswith(node_hex):
                    if not n["alive"]:
                        return {"error": f"node {node_hex} is dead"}
                    return get_client(n["address"]).call("debug_state")
            return {"error": f"no such node {node_hex}"}
        return state_api.debug_rows(self._cli)

    def objects(self) -> list:
        return state_api.store_rows(self._cli)

    def stop(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except OSError:
            pass
        self._thread.join()
