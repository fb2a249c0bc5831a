"""Server entry point (the port's copy of flux_generator_tpu/server/app.py).

    python -m flux_generator_tpu_torch.server.app [--port 7860] [--listen-all]
        [--warmup MODEL] [--quantize] [--w8a8 [ops|rows|fused]]

Checkpoints load on first use from the local Hugging Face hub cache
($HF_HUB_CACHE, else $HF_HOME/hub, else ~/.cache/huggingface/hub; see
io/loaders); FLUX_SCHNELL / FLUX_DEV / AE name Flux files in place of it.
The server runs on the current CUDA device; started by torchrun, each
process first joins the process group (parallel/distributed.py).
"""

from __future__ import annotations

import argparse
import socket

from .api import FluxAPI
from .httpd import Server

W8A8_ROUTES = ("ops", "rows", "fused")


def check_port_available(host: str, port: int) -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        try:
            s.bind((host, port))
            return True
        except OSError:
            return False


def find_available_port(host: str, start_port: int, max_attempts: int = 10) -> int:
    for port in range(start_port, start_port + max_attempts):
        if check_port_available(host, port):
            return port
    raise RuntimeError(f"Could not find an available port in range {start_port}-{start_port + max_attempts - 1}")


def get_app(pipeline_factory=None, sd_factory=None, **kwargs):
    """The FluxAPI, without binding a port (tests and smoke runs hand in
    pipeline factories; `kwargs` go to FluxAPI: quantize, w8a8, budget_gb,
    max_queue)."""
    return FluxAPI(pipeline_factory=pipeline_factory, sd_factory=sd_factory, **kwargs)


def main(argv=None):
    # several processes (torchrun): join the group before any device query;
    # a no-op in a single process
    from ..parallel.distributed import initialize_multihost, process_info

    initialize_multihost()
    pinfo = process_info()
    if pinfo["process_count"] > 1:
        print(f"multi-process serving: {pinfo}", flush=True)
    parser = argparse.ArgumentParser(description="Flux Generator server (PyTorch, CUDA)")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--listen-all", action="store_true", help="listen on all interfaces (0.0.0.0)")
    parser.add_argument("--warmup", metavar="MODEL",
                        help="load MODEL and serve one 512x512 request before serving")
    parser.add_argument("--quantize", action="store_true",
                        help="load every model with int8 weights at least (the planner may pick int4 for Flux)")
    parser.add_argument("--w8a8", nargs="?", const="ops", choices=W8A8_ROUTES, default=None,
                        help="int8 activations on the int8 weights of quantized models: 'ops' (the default "
                             "when the flag has no value), 'rows' (kernel H, then cuBLAS's int8 GEMM) or "
                             "'fused' (kernel G)")
    args = parser.parse_args(argv)

    host = "0.0.0.0" if args.listen_all else "127.0.0.1"
    port = args.port
    if not check_port_available(host, port):
        port = find_available_port(host, port + 1)
        print(f"Port {args.port} busy; using {port}")

    api = FluxAPI(quantize=args.quantize, w8a8=args.w8a8)
    if args.warmup:
        print(f"Warming up {args.warmup} (load + one 512x512 request)...", flush=True)
        api.generate_images("warmup", model=args.warmup, width=512, height=512)
        print("Warmup done.", flush=True)
    server = Server(api, host, port)
    shown = "localhost" if host == "127.0.0.1" else host
    print(f"Serving UI + A1111 API at http://{shown}:{port}/ (Ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
