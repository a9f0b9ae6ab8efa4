#!/usr/bin/env python3
"""Registers and spills of the attention kernels (K1, K5, K6) of this tree
against another tree's, from `nvcc -Xptxas -v`, on the machine with the
card (nvcc there); K2's and K3's kernels are printed beside them.

    python3 scripts/torch_ptxas_compare.py build/parent

The other tree is a checkout unpacked beside this one, e.g.
`git archive <commit> | tar -x -C build/parent`. Each tree's kernels are
built by its own robot3dlotus_tpu_torch.ops.cuda_lib.build() (the two
builds side by side), then every attention kernel instantiation is keyed
by (kernel, head dim, dtype, options) and its ptxas line printed for both
trees (the options' key: scale, rpe, the probabilities rounded to
bf16: upcast_attention's mixed route). The
instantiations without the attention options (the release model's) must
be equal; the script exits 1 otherwise. Writes
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
    # (an older tree's LogitOpts has the first two arguments only; K1's
    # InlineOpts has LogitOpts' three, its BiasTileOpts (scale, round) with
    # the bias on)
    o = re.search(r"(Logit|Inline)OptsILb(\d)ELb(\d)E(?:Lb(\d)E)?", name)
    t = re.search(r"BiasTileOptsILb(\d)ELb(\d)E", name)
    opts = (f"scale {t.group(1)} rpe 1 round {t.group(2)} tile" if t else
            "none" if not o or o.groups()[1:3] == ("0", "0") else
            f"scale {o.group(2)} rpe {o.group(3)} round {o.group(4) or 0}"
            + (" inline" if o.group(1) == "Inline" else ""))
    return (m.group(1), int(m.group(2)),
            "bf16" if "bfloat16" in name else "fp32", opts)


def conv_key(name):
    """(kernel, its mangled template arguments) of a K2 / K3 kernel."""
    m = re.search(r"\d((?:stem_conv|subm_conv)\w*?_kernel)(I\w+?E)v", name)
    return None if not m else (m.group(1), m.group(2))


def main():
    other = os.path.abspath(sys.argv[1])
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", BUILD], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, root in (("other", other), ("this", ROOT))}
    tables, convs = {}, {}
    for name, p in procs.items():
        out, _ = p.communicate()
        print(f"[{name}] rc {p.returncode}: {out[-2000:]}", flush=True)
        if p.returncode:
            return 1
        so = [line for line in out.splitlines() if line.endswith(".so")][0]
        used = usage(so[:-3] + ".ptxas.txt")
        tables[name] = {key(k): v for k, v in used.items() if key(k)}
        convs[name] = {conv_key(k): v for k, v in used.items()
                       if conv_key(k)}
    same = True
    for k in sorted(set(tables["other"]) | set(tables["this"]), key=str):
        a, b = tables["other"].get(k), tables["this"].get(k)
        if k[3] == "none" and a != b:
            same = False
        print(f"{k}: other {a} | this {b}"
              + ("" if k[3] != "none" or a == b else "  <-- differs"))
    print(f"release attention instantiations equal: {same}")
    for k in sorted(set(convs["other"]) | set(convs["this"]), key=str):
        print(f"{k}: other {convs['other'].get(k)} | this "
              f"{convs['this'].get(k)}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ptxas_attention.json"),
              "w") as f:
        json.dump({n: {" ".join(map(str, k)): v for k, v in
                       {**t, **convs[n]}.items()}
                   for n, t in tables.items()}, f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
