"""HTTP generation service over a serving artifact.

    python -m vqgan_tpu_torch.serve_http --artifact serving_artifact \\
        [--host 127.0.0.1] [--port 8000] [--seed 0] [--device cuda]

Counterpart of cli/serve_http.py: a stdlib HTTP daemon that loads one
artifact written by `export_serving` and answers generation requests with
no model code (it imports only `serving/`).

Endpoints:
  GET  /healthz    {"status": "ok", "batch_size": B, "num_users": N,
                    "warm": bool, "requests": n}
  POST /generate   body {"user_id": 1-based int, "num_images": int,
                         "seed": optional int}
                   -> {"user_id": u, "images": [base64 JPEG q95, ...],
                       "latency_s": t}
                   400 for a malformed body or a user id out of range

The artifact's programs have a fixed batch size; requests are tiled into
full batches and surplus images dropped. One lock serialises the device
work (one program, many HTTP threads). At start the service generates one
batch, so the first request pays no warm-up. `--port 0` binds a free port;
the startup line prints the port bound. Runs on the GPU by default.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .serving import load_cfg_sampler

__all__ = ["GenerationService", "make_handler", "main"]


class GenerationService:
    """Owns the loaded artifact; device work serialised by one lock."""

    def __init__(self, artifact: str, seed: int = 0, device="cuda"):
        self._sample = load_cfg_sampler(artifact, device)
        self.batch = self._sample.batch_size
        self.num_users = self._sample.num_users
        self._generator = torch.Generator(
            device=self._sample.device).manual_seed(seed)
        self._lock = threading.Lock()
        self.requests = 0
        self.warm = False

    def warmup(self):
        self.generate(user_id=1, num_images=1, seed=0)
        self.warm = True

    def generate(self, user_id: int, num_images: int, seed=None):
        """A list of uint8 [H, W, 3] arrays. A request with `seed` draws its
        noise from a generator of that seed, one without it from the
        service's own."""
        if not 1 <= user_id <= self.num_users:
            raise ValueError(
                f"user_id must be in [1, {self.num_users}], got {user_id}")
        if num_images < 1:
            raise ValueError("num_images must be >= 1")
        classes = torch.full((self.batch,), user_id - 1, dtype=torch.long)
        out = []
        with self._lock:
            self.requests += 1
            generator = self._generator
            if seed is not None:
                generator = torch.Generator(
                    device=self._sample.device).manual_seed(int(seed))
            while len(out) < num_images:
                imgs = self._sample(classes, generator=generator)
                imgs = imgs.cpu().numpy()
                for img in imgs[:min(self.batch, num_images - len(out))]:
                    out.append(np.clip(img * 255.0, 0, 255).astype(np.uint8))
        return out


def _jpeg_b64(arr) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_handler(svc: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # one-line access log
            print(f"{self.address_string()} {fmt % args}", flush=True)

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, {"status": "ok", "batch_size": svc.batch,
                              "num_users": svc.num_users, "warm": svc.warm,
                              "requests": svc.requests})

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                user_id = int(req["user_id"])
                num_images = int(req.get("num_images", 1))
                seed = req.get("seed")
                if seed is not None:
                    seed = int(seed)
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                return self._reply(400, {"error": f"bad request: {e}"})
            try:
                t0 = time.perf_counter()
                imgs = svc.generate(user_id, num_images, seed)
                dt = time.perf_counter() - t0
            except ValueError as e:
                return self._reply(400, {"error": str(e)})
            self._reply(200, {"user_id": user_id,
                              "images": [_jpeg_b64(a) for a in imgs],
                              "latency_s": dt})

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", required=True,
                    help="serving directory from export_serving")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 binds a free port (the startup line prints it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_warmup", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    svc = GenerationService(args.artifact, seed=args.seed, device=args.device)
    if not args.no_warmup:
        t0 = time.perf_counter()
        svc.warmup()
        print(f"warmup done in {time.perf_counter() - t0:.3f} s", flush=True)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(svc))
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(batch {svc.batch}, {svc.num_users} users)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
