"""HTTP server for the A1111 API and the web UI (the port's copy of
flux_generator_tpu/server/httpd.py).

The standard library's ThreadingHTTPServer, with the JAX package's routes,
open CORS headers and status codes: 404 for an unknown route, 422 for a
request that does not validate (ValueError, the schemas' and the API's), 429
when the queue is full, 500 for any other error. If FastAPI imports,
create_fastapi_app() mounts the same surface on it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .api import FluxAPI, QueueFullError
from .schemas import Img2ImgRequest, MusicRequest, SDAPIRequest


def make_handler(api: FluxAPI):
    from . import ui

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quieter than default
            pass

        # ---------------- helpers

        def _send(self, code: int, body: bytes, ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode())

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length else b"{}"
            return json.loads(raw or b"{}")

        # ---------------- routing

        def do_OPTIONS(self):
            self._send(204, b"")

        def do_GET(self):
            path = self.path.split("?")[0]
            try:
                if path == "/sdapi/v1/sd-models":
                    self._json(200, api.list_models())
                elif path == "/sdapi/v1/options":
                    self._json(200, api.get_options())
                elif path == "/sdapi/v1/progress":
                    self._json(200, api.get_progress())
                elif path in ("/", "/index.html"):
                    self._send(200, ui.INDEX_HTML.encode(), "text/html; charset=utf-8")
                elif path == "/docs":
                    self._send(200, ui.DOCS_HTML.encode(), "text/html; charset=utf-8")
                elif path == "/health":
                    self._json(200, {"status": "ok"})
                else:
                    self._json(404, {"detail": "Not Found"})
            except Exception as e:  # noqa: BLE001 — HTTP 500 with the error's text
                self._json(500, {"detail": str(e)})

        def do_POST(self):
            path = self.path.split("?")[0]
            try:
                if path == "/sdapi/v1/txt2img":
                    req = SDAPIRequest(**self._read_json())
                    resp = api.txt2img(req)
                    self._json(200, resp.model_dump())
                elif path == "/sdapi/v1/img2img":
                    req = Img2ImgRequest(**self._read_json())
                    self._json(200, api.img2img(req).model_dump())
                elif path == "/sdapi/v1/options":
                    self._json(200, api.set_options(self._read_json()))
                elif path == "/api/music":
                    req = MusicRequest(**self._read_json())
                    audios, sr = api.generate_music(
                        req.prompt, req.max_steps, req.top_k, req.temperature,
                        req.guidance, req.seed if req.seed >= 0 else None,
                        req.n_samples,
                    )
                    import base64
                    import io as _io

                    from ..utils.audio import save_audio

                    def to_url(audio):
                        buf = _io.BytesIO()
                        save_audio(buf, audio, sr)
                        return ("data:audio/wav;base64,"
                                + base64.b64encode(buf.getvalue()).decode())

                    urls = [to_url(a) for a in audios]
                    self._json(200, {
                        "audio": urls[0],  # back-compat single-sample field
                        "audios": urls,
                        "sampling_rate": sr,
                        "duration_s": round(len(audios[0]) / sr, 2),
                    })
                else:
                    self._json(404, {"detail": "Not Found"})
            except QueueFullError as e:
                self._json(429, {"detail": str(e)})
            except ValueError as e:
                self._json(422, {"detail": str(e)})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"detail": str(e)})

    return Handler


class Server:
    def __init__(self, api: FluxAPI, host: str = "127.0.0.1", port: int = 7860):
        self.api = api
        self.httpd = ThreadingHTTPServer((host, port), make_handler(api))
        self.host, self.port = self.httpd.server_address[:2]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def create_fastapi_app(api: FluxAPI):
    """The same routes on FastAPI, where it is installed."""
    from fastapi import FastAPI
    from fastapi.middleware.cors import CORSMiddleware

    app = FastAPI()
    app.add_middleware(
        CORSMiddleware, allow_origins=["*"], allow_credentials=True,
        allow_methods=["*"], allow_headers=["*"],
    )

    @app.post("/sdapi/v1/txt2img")
    async def txt2img(request: SDAPIRequest):
        return api.txt2img(request)

    @app.get("/sdapi/v1/sd-models")
    async def list_models():
        return api.list_models()

    @app.get("/sdapi/v1/options")
    async def get_options():
        return api.get_options()

    @app.post("/sdapi/v1/options")
    async def set_options(options: dict):
        return api.set_options(options)

    @app.get("/sdapi/v1/progress")
    async def get_progress():
        return api.get_progress()

    return app
