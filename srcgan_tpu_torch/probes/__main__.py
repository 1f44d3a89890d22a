"""``python -m srcgan_tpu_torch.probes [matmul|mxu|layout ...] [abcd] [--device cpu]``:
the named sweeps (all three by default); a trailing word of the letters abcd
picks the parts of the layout sweep."""
from __future__ import annotations

import sys

from srcgan_tpu_torch.probes import layout_probe3, matmul_probe, mxu_probe

SWEEPS = {"matmul": matmul_probe, "mxu": mxu_probe, "layout": layout_probe3}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags, words, i = [], [], 0
    while i < len(argv):
        if argv[i] == "--device":
            flags += argv[i:i + 2]
            i += 2
        elif argv[i].startswith("-"):
            flags.append(argv[i])
            i += 1
        else:
            words.append(argv[i])
            i += 1
    parts = [w for w in words if w not in SWEEPS]
    if len(parts) > 1:
        raise SystemExit(f"usage: python -m srcgan_tpu_torch.probes [{'|'.join(SWEEPS)} ...] "
                         f"[abcd] [--device cpu]; got {words}")
    names = [w for w in words if w in SWEEPS] or list(SWEEPS)
    out = {}
    for name in names:
        extra = parts if name == "layout" else []
        out[name] = SWEEPS[name].main(extra + flags)
    return out


if __name__ == "__main__":
    main()
