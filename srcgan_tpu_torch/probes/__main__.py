"""``python -m srcgan_tpu_torch.probes [matmul|mxu|layout ...] [abcd] [--device cpu]``:
the named sweeps (all three by default); a trailing word of the letters abcd
picks the parts of the layout sweep.

``python -m srcgan_tpu_torch.probes rdb5 [--rounds N]``: the ablation of the
RDB5 kernel's design (``rdb5_ablate``: every variant of ``csrc/rdb5.cu`` built,
held against the plain version and timed in turns).  ``... probes tail
[--rounds N]``: the x4 tail's main kernel against its first design
(``tail_ablate``).  ``... probes ssim [--rounds N]``: the ablation of the SSIM
kernel (``ssim_ablate``: its variants and its main pass with parts left out).
``... probes chain [--rounds N]``: the ablation of the dependent-dot chain
kernel of probe_mxu and probe_dots (``chain_ablate``: its variants, its
first design and builds with work left out, in turns at the table shapes).  Each
runs only when named, and only on the card."""
from __future__ import annotations

import sys

from srcgan_tpu_torch.probes import (chain_ablate, layout_probe3, matmul_probe, mxu_probe,
                                     rdb5_ablate, ssim_ablate, tail_ablate)

SWEEPS = {"matmul": matmul_probe, "mxu": mxu_probe, "layout": layout_probe3}
NAMED_ONLY = {"rdb5": rdb5_ablate, "tail": tail_ablate, "ssim": ssim_ablate,
              "chain": chain_ablate}
USAGE = (f"usage: python -m srcgan_tpu_torch.probes [{'|'.join(SWEEPS)} ...] [abcd] "
         f"[--device cpu]  |  python -m srcgan_tpu_torch.probes {'|'.join(NAMED_ONLY)} [--rounds N]")


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags, words, i = [], [], 0
    while i < len(argv):
        if argv[i] in ("--device", "--rounds"):
            flags += argv[i:i + 2]
            i += 2
        elif argv[i].startswith("-"):
            flags.append(argv[i])
            i += 1
        else:
            words.append(argv[i])
            i += 1
    if not words and ("-h" in flags or "--help" in flags):
        print(__doc__)
        print(USAGE)
        return {}
    if any(w in NAMED_ONLY for w in words):
        if len(words) > 1:
            raise SystemExit(f"{USAGE}; got {words}")
        return {words[0]: NAMED_ONLY[words[0]].main(flags)}
    parts = [w for w in words if w not in SWEEPS]
    if len(parts) > 1:
        raise SystemExit(f"{USAGE}; got {words}")
    names = [w for w in words if w in SWEEPS] or list(SWEEPS)
    out = {}
    for name in names:
        extra = parts if name == "layout" else []
        out[name] = SWEEPS[name].main(extra + flags)
    return out


if __name__ == "__main__":
    main()
