"""Live training dashboard (the port's copy of ``srcgan_tpu.utils.live``,
standard library only).

The Logger writes one PNG per image window into a run directory
(utils/logging.py); LiveView is a zero-dependency stdlib HTTP server over that
directory, so a run can be watched from a browser: the same window-per-name images render on one
auto-refreshing page, alongside the loss history the Logger appends to
``losses.jsonl``.  Visdom's default port (8097) is kept.

Endpoints:
  GET /              dashboard page (windows + latest losses, auto-refresh)
  GET /img/<name>    a window PNG, served no-cache
  GET /windows.json  current window names (the page syncs its <img> list
                     against this every tick, so windows that appear
                     mid-run — or after the first compile — show up without
                     a manual reload)
  GET /losses.json   recent loss history (bounded tail of losses.jsonl):
                     ``[{"epoch", "iter", "t", "losses"}, ...]``

The server binds loopback by default; pass ``host="0.0.0.0"`` (CLI
``--live-host`` / ``--host``) to expose it — the endpoints are
unauthenticated, so widening the bind is an explicit opt-in.

Usage — inside a trainer (``--live-port`` on the train CLIs)::

    live = LiveView("runs/latest", port=8097).start()
    ...training loop (Logger writes into runs/latest)...
    live.stop()

or standalone over a directory an unrelated run is writing to::

    python -c "from srcgan_tpu_torch.utils.live import LiveView; import time; \\
               LiveView('runs/latest', port=8097).start(); time.sleep(1e9)"
"""
from __future__ import annotations

import html
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>srcgan_tpu_torch live</title>
<style>
 body {{ font-family: sans-serif; background: #111; color: #ddd; margin: 1em; }}
 .win {{ display: inline-block; margin: .5em; vertical-align: top; }}
 .win div {{ font-size: .8em; color: #9ab; margin-bottom: .2em; }}
 img {{ image-rendering: pixelated; max-width: 512px; border: 1px solid #333; }}
 table {{ border-collapse: collapse; margin-top: 1em; }}
 td, th {{ border: 1px solid #333; padding: .2em .6em; font-size: .85em; }}
</style></head>
<body>
<h3>srcgan_tpu_torch live &mdash; {dir}</h3>
<div id="wins">{wins}</div>
<table id="losses"><tr><td>waiting for losses.jsonl&hellip;</td></tr></table>
<script>
function bust(el) {{ el.src = el.dataset.base + '?t=' + Date.now(); }}
async function syncWindows() {{
  // windows appear mid-run (the first PNG lands only after the first
  // compile + log step): sync the <img> list against the server each tick
  const names = await (await fetch('/windows.json')).json();
  const box = document.getElementById('wins');
  const have = new Set([...box.querySelectorAll('.win')].map(w => w.dataset.n));
  if (have.size === 0) box.innerHTML = '';  // drop the "no windows yet" note
  for (const n of names) {{
    if (have.has(n)) continue;
    const span = document.createElement('span');
    span.className = 'win'; span.dataset.n = n;
    const cap = document.createElement('div'); cap.textContent = n;
    const img = document.createElement('img');
    img.dataset.base = '/img/' + encodeURIComponent(n);
    span.append(cap, img); box.append(span);
  }}
  for (const w of box.querySelectorAll('.win'))
    if (!names.includes(w.dataset.n)) w.remove();
}}
async function tick() {{
  try {{ await syncWindows(); }} catch (e) {{}}
  document.querySelectorAll('img[data-base]').forEach(bust);
  try {{
    const rows = await (await fetch('/losses.json')).json();
    if (rows.length) {{
      const keys = Object.keys(rows[rows.length - 1].losses);
      let h = '<tr><th>epoch</th><th>iter</th>' +
              keys.map(k => '<th>' + k + '</th>').join('') + '</tr>';
      for (const r of rows.slice(-12).reverse())
        h += '<tr><td>' + r.epoch + '</td><td>' + r.iter + '</td>' +
             keys.map(k => '<td>' + (+r.losses[k]).toFixed(4) + '</td>')
                 .join('') + '</tr>';
      document.getElementById('losses').innerHTML = h;
    }}
  }} catch (e) {{}}
}}
setInterval(tick, 2000); tick();
</script>
</body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    run_dir = "."  # overridden per-server via the factory in LiveView

    def log_message(self, *a):  # quiet: training stdout is the log line
        pass

    def _send(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def _windows(self) -> List[str]:
        try:
            # dotfiles excluded: the Logger writes each window atomically
            # via a hidden ".name.png" temp + os.replace (utils/logging.py)
            names = sorted(f for f in os.listdir(self.run_dir)
                           if f.endswith(".png") and not f.startswith("."))
        except OSError:
            names = []
        return names

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/":
            wins = "".join(
                '<span class="win" data-n="{n}"><div>{n}</div>'
                '<img data-base="/img/{n}" src="/img/{n}"></span>'
                .format(n=html.escape(n)) for n in self._windows())
            body = _PAGE.format(dir=html.escape(self.run_dir),
                                wins=wins or "<i>no windows yet</i>")
            self._send(200, "text/html; charset=utf-8", body.encode())
        elif path == "/windows.json":
            self._send(200, "application/json",
                       json.dumps(self._windows()).encode())
        elif path == "/losses.json":
            # bounded tail: the page shows the last 12 rows; shipping (and
            # re-parsing) the full history every 2 s poll would grow without
            # bound over a long run — read only the file's last ~128 KB
            rows = []
            try:
                with open(os.path.join(self.run_dir, "losses.jsonl"),
                          "rb") as f:
                    f.seek(0, os.SEEK_END)
                    start = max(0, f.tell() - 131072)
                    f.seek(start)
                    chunk = f.read().decode("utf-8", "replace")
                lines = chunk.splitlines()
                if start > 0:
                    lines = lines[1:]  # drop the line the seek cut mid-way
                for ln in lines[-256:]:
                    if ln.strip():
                        try:
                            rows.append(json.loads(ln))
                        except ValueError:
                            pass  # a row being appended concurrently
            except OSError:
                pass
            self._send(200, "application/json", json.dumps(rows).encode())
        elif path.startswith("/img/"):
            # basename() forecloses traversal; only window PNGs are served
            name = os.path.basename(path[len("/img/"):])
            if not name.endswith(".png"):
                return self._send(404, "text/plain", b"not found")
            try:
                with open(os.path.join(self.run_dir, name), "rb") as f:
                    self._send(200, "image/png", f.read())
            except OSError:
                self._send(404, "text/plain", b"not found")
        else:
            self._send(404, "text/plain", b"not found")


class _QuietServer(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        # A browser abandoning a cache-busted image fetch mid-body is
        # routine; socketserver's default handle_error would interleave a
        # full traceback with the trainer's \r-rewritten progress line.
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            TimeoutError)):
            return
        super().handle_error(request, client_address)


class LiveView:
    """Threaded dashboard server over a Logger run directory.

    ``port=0`` binds an ephemeral port (tests); ``.port`` reports the bound
    one.  The server thread is a daemon, so a crashed trainer never hangs on
    it, but call :meth:`stop` for an orderly shutdown.
    """

    def __init__(self, run_dir: str, port: int = 8097,
                 host: str = "127.0.0.1"):
        self.run_dir = run_dir
        handler = type("_BoundHandler", (_Handler,), {"run_dir": run_dir})
        self._srv = _QuietServer((host, port), handler)
        self.port = self._srv.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LiveView":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def add_live_flag(parser) -> None:
    """``--live-port`` / ``--live-host`` for the train CLIs."""
    parser.add_argument("--live-port", type=int, default=None,
                        help="serve a live dashboard (the Visdom-server "
                             "replacement) over the run directory on this "
                             "port while training; 0 = ephemeral port")
    parser.add_argument("--live-host", type=str, default="127.0.0.1",
                        help="dashboard bind address; the endpoints are "
                             "unauthenticated, so exposing beyond loopback "
                             "(e.g. 0.0.0.0) is an explicit opt-in")


def maybe_start(args, run_dir: str = "runs/latest") -> Optional[LiveView]:
    """Start a LiveView if ``--live-port`` was given; caller stops it."""
    if getattr(args, "live_port", None) is None:
        return None
    live = LiveView(run_dir, port=args.live_port,
                    host=getattr(args, "live_host", "127.0.0.1")).start()
    print(f"live dashboard: http://localhost:{live.port}/")
    return live
