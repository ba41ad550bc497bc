#!/usr/bin/env python3
"""Compare the machine code of two trees of the package, function by function.

    python -m dpmn_tpu_torch.tools.sass_compare PARENT_ROOT [CHANGE_ROOT]

Each root holds a `dpmn_tpu_torch` package (CHANGE_ROOT defaults to the
current directory).  Builds every kernel library of both (`build_all`, in a
process of each tree), dumps each with `cuobjdump -sass`, cuts the dumps into
functions and compares the bodies of the functions both hold.  A body is
normalized first: the address comments dropped, the whitespace collapsed,
the branch labels (.L_x_N, numbered across a library) renumbered within the
function, the anonymous namespace's per-build hash blanked.  Functions are
keyed by their demangled name with template arguments that name their
defaults dropped (trailing `float` type arguments: the io types of a kernel
that later gained a bf16 form; the parent's `wgrad_kernel<false, R16>` is
the change's `wgrad_kernel<R16>`; the parent's bool BF16 argument of the
attention backward kernels, since derived from their io type), so a kernel that kept its code under a
longer template list still matches.  Needs the card's toolkit (nvcc,
cuobjdump, cu++filt); prints one JSON object a library and a total.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


def build(root: Path) -> dict:
    """{library name: path of its built .so} of the tree at root."""
    code = ("import json; from dpmn_tpu_torch.ops import kernels; kernels.build_all(); "
            "print(json.dumps({n: str(kernels._target(n)) for n in kernels.SOURCES}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def key(name: str) -> str:
    name = re.sub(r"\((int|bool|unsigned int|float)\)|\(anonymous namespace\)::|<unnamed>::|^void ", "", name)
    name = name.split("(")[0].strip()  # cu++filt's casts of template values and namespaces gone: the arguments
    name = re.sub(r"wgrad_kernel<(false|0), (true|false|1|0)>", r"wgrad_kernel<\2>", name)
    # the attention backward's former BF16 argument, dropped where it equals
    # what the io type now implies (1 for bf16 rows, 0 for float32 ones)
    m = re.match(r"(window_attn_bwd4_kernel<\w+|window_attn_bwd_kernel<\w+, \w+|window_attn_bwd_tc_kernel<\w+, \w+, "
                 r"\w+), ([01]|true|false)(, .*|>)$", name)
    if m and (m.group(2) in ("1", "true")) == ("__nv_bfloat16" in m.group(3)):
        name = m.group(1) + m.group(3)
    name = re.sub(r"<float>$", "", name)
    while name.endswith(", float>"):  # trailing io-type arguments at their default, one or several
        name = name[: -len(", float>")] + ">"
    return name


def functions(lib: str) -> dict:
    """{key: normalized body} of every function of a library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : ", sass)[1:]
    mangled = [p.split(None, 1)[0] for p in parts]
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = subprocess.run([filt], input="\n".join(mangled), capture_output=True, text=True).stdout.splitlines()
    out = {}
    for name, body in zip(names, parts):
        body = body.split("\n", 1)[1] if "\n" in body else ""
        body = re.sub(r"/\*[0-9a-f]{4,}\*/", "", body)
        body = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", body)
        labels = {}
        body = re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(m.group(0), f".L{len(labels)}"), body)
        out[key(name)] = " ".join(body.split())
    return out


def main():
    parent = Path(sys.argv[1]).resolve()
    change = Path(sys.argv[2] if len(sys.argv) > 2 else ".").resolve()
    libs_p, libs_c = build(parent), build(change)
    total = {"same": 0, "different": [], "parent_only": 0, "change_only": 0}
    for name in sorted(set(libs_p) & set(libs_c)):
        fp, fc = functions(libs_p[name]), functions(libs_c[name])
        both = sorted(set(fp) & set(fc))
        diff = [k for k in both if fp[k] != fc[k]]
        row = {"library": name, "same": len(both) - len(diff), "different": diff,
               "parent_only": sorted(set(fp) - set(fc)), "change_only": sorted(set(fc) - set(fp))}
        print(json.dumps(row), flush=True)
        total["same"] += row["same"]
        total["different"] += [f"{name}: {k}" for k in diff]
        total["parent_only"] += len(row["parent_only"])
        total["change_only"] += len(row["change_only"])
    print(json.dumps({"total": total}), flush=True)


if __name__ == "__main__":
    main()
