#!/usr/bin/env python3
"""The patch embedding's machine code beside another checkout's, on a machine with nvcc.

    python3 scripts/embed_sass_compare.py OTHER_CHECKOUT

Compiles this tree's and OTHER_CHECKOUT's ``csrc/patch_embed.cu`` to cubins
with the library's nvcc flags, disassembles both (``cuobjdump -sass``) and,
for each instantiation of this tree's packed walk (4 channels, the table's
rows in shared memory: ``patch_embed_kernel<T, NB, MW, NW, 4, true>``),
prints its instruction count beside the other checkout's kernel of the same
(T, NB, MW, NW) and the instructions that differ once constants and
addresses are masked. 0 differing means the same machine code: the two
kernels' times can differ only by the card's noise. Needs no GPU; imports
nothing of JAX.
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402

PACKED = ("4", "1")  # the packed walk's (CH, TAB)
TYPES = {"f": "float", "13__nv_bfloat16": "bf16"}


def template_args(mangled: str) -> tuple:
    """(T, NB, MW, NW[, CH, TAB]) of a mangled ``patch_embed_kernel``, or ()."""
    m = re.search(r"patch_embed_kernelI(f|13__nv_bfloat16)((?:L[ib]\d+E)+)E", mangled)
    return (TYPES[m.group(1)], *re.findall(r"L[ib](\d+)E", m.group(2))) if m else ()


def functions(cubin: Path) -> dict:
    """{template args: [instructions, constants and addresses masked]} of
    the cubin's patch_embed kernels."""
    sass = subprocess.run([str(Path(_native._nvcc()).parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = template_args(m.group(1)) or None
            if cur:
                out[cur] = []
        elif cur and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            ins = re.sub(r"/\*[0-9a-f]+\*/", "", line).strip().rstrip(";").strip()
            out[cur].append(re.sub(r"0x[0-9a-f]+", "X", ins))
    return out


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    trees = {"this": ROOT, "other": Path(sys.argv[1]).resolve()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        code = {}
        for label, tree in trees.items():
            csrc = tree / "surface_vision_transformers_tpu_torch" / "csrc"
            cubin = tmp / f"{label}.cubin"
            subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-cubin", f"-I{csrc}",
                            str(csrc / "patch_embed.cu"), "-o", str(cubin)],
                           check=True, capture_output=True)
            code[label] = functions(cubin)
    packed = [a for a in code["this"] if a[4:] == PACKED]
    if not packed:
        raise SystemExit("embed_sass_compare: no packed-walk kernel found in this tree's cubin")
    for args in sorted(packed):
        ins = code["this"][args]
        other = code["other"].get(args[:4])
        if other is None:
            print(f"patch_embed_kernel<{', '.join(args)}>: {len(ins)} instructions; the other "
                  "checkout has no kernel of these (T, NB, MW, NW)")
            continue
        diff = [d for d in difflib.unified_diff(other, ins, lineterm="", n=0)
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        print(f"patch_embed_kernel<{', '.join(args)}>: {len(ins)} instructions, the other "
              f"checkout's <{', '.join(args[:4])}> {len(other)}; {len(diff)} lines differ",
              flush=True)


if __name__ == "__main__":
    main()
