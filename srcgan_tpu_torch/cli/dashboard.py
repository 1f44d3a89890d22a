"""Standalone live dashboard over a run directory, as ``srcgan_tpu.cli.dashboard``.

The in-process route is ``--live-port`` on the train CLIs; this entry point
watches a run directory some OTHER process is writing to (a training job
started without the flag), as the reference's Visdom server runs apart from
training.

    python -m srcgan_tpu_torch.cli.dashboard --dir runs/latest --port 8097

It serves files only; ``--device`` names the card whose run it watches
(the default, an error without one) or ``cpu``, and the startup line
reports it.
"""
from __future__ import annotations

import argparse
import time


def build_parser():
    p = argparse.ArgumentParser(description="live dashboard over a run directory")
    p.add_argument("--dir", default="runs/latest",
                   help="run directory a Logger writes windows and losses into")
    p.add_argument("--port", type=int, default=8097,
                   help="HTTP port (Visdom's default); 0 = ephemeral")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address; the endpoints are unauthenticated, so "
                        "exposing beyond loopback (e.g. 0.0.0.0) is an explicit opt-in")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the watched run uses: the card by default (an "
                        "error without one); 'cpu' for a CPU run")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.utils.live import LiveView

    device = config.resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    live = LiveView(args.dir, port=args.port, host=args.host).start()
    print(f"live dashboard over {args.dir} ({name}): http://localhost:{live.port}/",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        live.stop()


if __name__ == "__main__":
    main()
