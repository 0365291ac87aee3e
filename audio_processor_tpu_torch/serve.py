"""Service entry point of the PyTorch port: the meeting-notes server.

Builds the port's service stack (models on the card, job engine on a
shared sqlite store so several processes share one queue) and runs the
WSGI app:

    python -m audio_processor_tpu_torch.serve               # dev server on :5000
    APTPU_MODEL=small python -m audio_processor_tpu_torch.serve --port 8080
    APTPU_DEVICE=cpu python -m audio_processor_tpu_torch.serve   # the plain path

On a (data, model) mesh, one process a rank (here dp2 x tp2 on four
cards; on the CPU add ``APTPU_DEVICE=cpu``, and the ranks talk over gloo):

    APTPU_DISTRIBUTED=1 APTPU_MODEL_PARALLEL=2 \\
        torchrun --nproc-per-node 4 -m audio_processor_tpu_torch.serve --port 8080

Rank 0 serves HTTP and runs the job engine; the other ranks build the same
models and follow rank 0's calls (``parallel/controller.py``) until it
stops.

The models run on the card; ``APTPU_DEVICE=cpu`` is the only way to the
CPU, and without a card the server refuses to start.
``application`` is the WSGI callable for a production server
(``<server> audio_processor_tpu_torch.serve:application``); it serves one
process, so a mesh is started with ``main`` as above.
"""
from __future__ import annotations

import argparse
import logging
import os
import threading


def build_services():
    from .runtime.services import build_services as build

    return build(
        model=os.environ.get("APTPU_MODEL", "tiny"),
        store_url=os.environ.get("JOB_STORE_URL", "sqlite://jobs.db"),
        max_workers=int(os.environ.get("MAX_WORKERS", "3")),
        model_path=os.environ.get("APTPU_MODEL_PATH"),
        device=os.environ.get("APTPU_DEVICE") or None,
    )


def build_app(services=None):
    from .server.app import create_app

    return create_app(build_services() if services is None else services)


# built lazily on the first request, under a lock: a threaded server fires
# many first requests at once, and each must not build its own Transcriber
# (device memory) and JobEngine (duplicate worker pools)
_wsgi_app = None
_wsgi_lock = threading.Lock()


def application(environ, start_response):
    global _wsgi_app
    if _wsgi_app is None:
        with _wsgi_lock:
            if _wsgi_app is None:
                _wsgi_app = build_app()
    return _wsgi_app(environ, start_response)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="audio_processor_tpu_torch.serve")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=int(os.environ.get("PORT", 5000)))
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    services = build_services()
    controller = services.controller
    if controller is None:
        build_app(services).run(host=args.host, port=args.port)
        return
    from .parallel import multihost

    # every rank leaves the process group before it exits: a gloo group
    # still up at interpreter exit can abort the process (SIGABRT)
    try:
        if controller.is_leader:
            try:
                build_app(services).run(host=args.host, port=args.port)
            finally:
                controller.stop()
        else:
            controller.follow()  # until rank 0 stops
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
