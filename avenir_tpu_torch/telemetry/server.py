"""The scrapeable serving endpoint (port of ``avenir_tpu/telemetry/
server.py``): /metrics + /healthz on a stdlib ``http.server`` daemon
thread.

One ThreadingHTTPServer per process, bound to the operator-chosen port
(``telemetry.metrics.port``; port 0 binds ephemeral and the chosen port
is printed/exposed via ``.port``).  ``/metrics`` renders the registry's
Prometheus text; ``/healthz`` aggregates the registry's health providers
— 200 with ``{"status": "ok"}`` when every provider reports healthy,
503 with the failing checks when any is degraded, which is exactly the
contract a load balancer's health probe consumes (a degraded serving
worker stops pulling traffic).  ``/exemplars`` is the JSON twin of the
histogram exemplars (bucket -> last sampled request id).  Anything else
is 404.

The server must never take the job down: handler errors answer 500,
logging is suppressed (stdlib BaseHTTPRequestHandler logs every request
to stderr otherwise), and ``stop()`` is idempotent.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricsRegistry

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


class MetricsServer:
    """Serve one registry's /metrics and /healthz until stopped."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry
        self.host = host
        self.port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: one line per scrape
                pass               # would flood the job's stderr

            def _answer(self, code: int, body: bytes,
                        content_type: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        # content negotiation, the real Prometheus
                        # protocol: exemplars are only legal in the
                        # OpenMetrics exposition, so the classic 0.0.4
                        # body stays exemplar-free and a scraper asking
                        # for openmetrics (what Prometheus sends when
                        # exemplar scraping is on) gets them
                        accept = self.headers.get("Accept", "") or ""
                        if "application/openmetrics-text" in accept:
                            self._answer(
                                200,
                                registry.render_openmetrics()
                                .encode("utf-8"),
                                OPENMETRICS_CONTENT_TYPE)
                        else:
                            self._answer(
                                200, registry.render().encode("utf-8"),
                                PROM_CONTENT_TYPE)
                    elif path == "/exemplars":
                        # the /metrics-adjacent JSON: histogram bucket
                        # -> last sampled request id, for tooling that
                        # should not have to parse the text exposition
                        self._answer(
                            200,
                            json.dumps(registry.exemplars_json(),
                                       sort_keys=True).encode(),
                            "application/json")
                    elif path == "/healthz":
                        ok, payload = registry.health()
                        self._answer(
                            200 if ok else 503,
                            json.dumps(payload, sort_keys=True).encode(),
                            "application/json")
                    elif path.startswith("/healthz/"):
                        # per-provider probe: /healthz/<name> answers for
                        # ONE health source (a fleet worker), so a load
                        # balancer can pull one degraded worker while its
                        # peers keep taking traffic
                        res = registry.health_one(path[len("/healthz/"):])
                        if res is None:
                            self._answer(404, b"no such health check\n",
                                         "text/plain")
                        else:
                            ok, payload = res
                            self._answer(
                                200 if ok else 503,
                                json.dumps(payload,
                                           sort_keys=True).encode(),
                                "application/json")
                    else:
                        self._answer(404, b"not found\n", "text/plain")
                except Exception as exc:  # scrape must not kill serving
                    try:
                        self._answer(500, f"{type(exc).__name__}: {exc}\n"
                                     .encode(), "text/plain")
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="avenir-metrics-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
