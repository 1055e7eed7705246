#!/usr/bin/env python3
"""Print the per-width unpack/pack schedules — the portable spec of the
mask math.

Port of the reference's mask-table prototypes
(scripts/decompression_parameters.py, scripts/decompression_masks.py,
scripts/decompression_masks8.py — SURVEY.md §2.3 S1): where the reference
prints byte offsets + paddings + `_mm_setr_epi8` shuffle masks per value
index, the device layout reduces all of it to (word index, shift, straddles)
per value-in-block, because blocks are word-aligned by construction.

Usage: python scripts/print_schedules.py [width ...]   (default: 1..31)
"""
from __future__ import annotations

import sys

sys.path.insert(0, ".")

from shared_simd_scan_tpu.layout import pack_schedule, unpack_schedule


def main(argv: list[str]) -> int:
    widths = [int(a) for a in argv] if argv else list(range(1, 32))
    for w in widths:
        print(f"== width {w}: 32 values <-> {w} uint32 words per block ==")
        print("  unpack: r -> (word k, shift s, straddles)  "
              "[v_r = (w[k]>>s | w[k+1]<<(32-s)) & mask]")
        for r, (k, s, st) in enumerate(unpack_schedule(w)):
            print(f"    r={r:2d}: k={k:2d} s={s:2d} {'straddle' if st else ''}")
        print("  pack: word j <- [(value r, shift, high-part?)]")
        for j, contribs in enumerate(pack_schedule(w)):
            terms = ", ".join(
                f"v{r}{'>>' if hi else '<<'}{sh}" for r, sh, hi in contribs
            )
            print(f"    w={j:2d}: {terms}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
