#!/usr/bin/env python3
"""Registers and spills of the attention kernels (K1, K5, K6) of this tree
against another tree's, from `nvcc -Xptxas -v`, on the machine with the
card (nvcc there).

    python3 scripts/torch_ptxas_compare.py build/parent

The other tree is a checkout unpacked beside this one, e.g.
`git archive <commit> | tar -x -C build/parent`. Each tree's kernels are
built by its own robot3dlotus_tpu_torch.ops.cuda_lib.build() (the two
builds side by side), then every attention kernel instantiation is keyed
by (kernel, head dim, dtype, options) and its ptxas line printed for both
trees. The instantiations without the attention options (the release
model's) must be equal; the script exits 1 otherwise. Writes
chiprun_out/ptxas_attention.json.
"""
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = ("import time; t = time.time(); "
         "from robot3dlotus_tpu_torch.ops import cuda_lib; "
         "print(cuda_lib.build()); print('build s', time.time() - t)")


def usage(path):
    """{mangled kernel name: 'registers, spills'} of a ptxas log."""
    out, entry, spills = {}, None, ""
    with open(path) as f:
        for line in f:
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and "spill stores" in line:
                spills = line.strip()
            elif entry and "Used" in line and "registers" in line:
                out[entry] = (line.split("Used")[1].split(",")[0].strip() +
                              ", " + spills)
                entry, spills = None, ""
    return out


def key(name):
    """(kernel, head dim, dtype, options) of an attention kernel's mangled
    name, None for another kernel."""
    m = re.search(r"\d((?:patch_attention|attn_drop)\w*?_kernel)ILi(\d+)E",
                  name)
    if not m:
        return None
    o = re.search(r"LogitOptsILb(\d)ELb(\d)E", name)
    opts = "none" if not o or o.groups() == ("0", "0") else \
        f"scale {o.group(1)} rpe {o.group(2)}"
    return (m.group(1), int(m.group(2)),
            "bf16" if "bfloat16" in name else "fp32", opts)


def main():
    other = os.path.abspath(sys.argv[1])
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", BUILD], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, root in (("other", other), ("this", ROOT))}
    tables = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        print(f"[{name}] rc {p.returncode}: {out[-2000:]}", flush=True)
        if p.returncode:
            return 1
        so = [line for line in out.splitlines() if line.endswith(".so")][0]
        tables[name] = {key(k): v for k, v in usage(so[:-3] + ".ptxas.txt")
                        .items() if key(k)}
    same = True
    for k in sorted(set(tables["other"]) | set(tables["this"]), key=str):
        a, b = tables["other"].get(k), tables["this"].get(k)
        if k[3] == "none" and a != b:
            same = False
        print(f"{k}: other {a} | this {b}"
              + ("" if k[3] != "none" or a == b else "  <-- differs"))
    print(f"release attention instantiations equal: {same}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ptxas_attention.json"),
              "w") as f:
        json.dump({n: {" ".join(map(str, k)): v for k, v in t.items()}
                   for n, t in tables.items()}, f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
