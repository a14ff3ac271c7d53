"""Pair STATS transcripts key by key with the stock binary's stream.

    python -m kangaroo_torch.stats_summary ours1.txt [ours2.txt ...]
        --ref ref.txt [--detail]

The port's copy of scripts/stats_summary.py, with the same regexes,
pairing and output.  It reads the per-key lines that stats_batch prints
(`key  N: priv=.. ops=2^.. ops/sqrtN=X dead=D`; the JAX script's
transcripts too) and the reference's STATS stream (`[idx] 2^c Dead:D
Avg:2^a ...`), then prints both averages on the keys both solved.  The
reference's own measured constant (not the 2.16 model) is the target:
both sides solved the same key list (fixtures/in40_1000.txt).  --detail
adds two lines: the standard error of each mean of ops/sqrt(N) and their
difference in units of it, and how many of the common keys' private keys
equal the stream's.
"""

from __future__ import annotations

import math
import re
import sys

OURS = re.compile(
    r"^key\s+(\d+): priv=0x[0-9A-F]+ ops=2\^([0-9.]+) "
    r"ops/sqrtN=([0-9.]+) dead=(\d+)"
)
OURS_PRIV = re.compile(r"^key\s+\d+: priv=0x([0-9A-F]+) ")
REF = re.compile(r"^\[\s*(\d+)\] 2\^([0-9.]+) Dead:(\d+) ")
REF_KEY = re.compile(r"^Key#\s*(\d+) ")
REF_PRIV = re.compile(r"^\s+Priv: 0x([0-9A-F]+)")
# the stock streams' range: 2^40 (fixtures/in40_*.txt)
REF_SQRT_N = math.sqrt(2.0 ** 40)


def read_ours(paths):
    """{key: (ops/sqrtN, dead, priv)} from stats_batch transcripts."""
    out = {}
    for path in paths:
        with open(path, errors="replace") as f:
            for line in f:
                m = OURS.match(line)
                if m:
                    priv = int(OURS_PRIV.match(line).group(1), 16)
                    out[int(m.group(1))] = (float(m.group(3)),
                                            int(m.group(4)), priv)
    return out


def read_ref(path):
    """{key: (ops, dead, priv)} from a stock STATS stream; ops is the
    stream's 2^c, priv the `Priv:` printed under the key's `Key#` line
    (None where the stream has none)."""
    out, privs, key = {}, {}, None
    with open(path, errors="replace") as f:
        for line in f:
            m = REF_KEY.match(line)
            if m:
                key = int(m.group(1))
                continue
            m = REF_PRIV.match(line)
            if m and key is not None:
                privs[key] = int(m.group(1), 16)
                continue
            m = REF.match(line)
            if m:
                k = int(m.group(1))
                out[k] = (2.0 ** float(m.group(2)), int(m.group(3)))
    return {k: (ops, dead, privs.get(k)) for k, (ops, dead) in out.items()}


def mean_se(xs):
    """(mean, standard error of the mean) of xs; the error is nan for
    one value."""
    n = len(xs)
    m = sum(xs) / n
    if n < 2:
        return m, float("nan")
    return m, math.sqrt(sum((x - m) ** 2 for x in xs) / (n - 1) / n)


def summarize(ours_paths, ref_path=None) -> dict:
    """The summary's numbers: ours over all keys read (`n`, `avg`,
    `dead`, and `se`, the standard error of `avg`) and, with ref_path,
    both sides on the keys both solved (`common`, `ref_avg`, `ref_dead`,
    `ours_avg`, `ours_dead`, `ratio`, the standard errors `ref_se`,
    `ours_se`, and `same_priv`, the keys whose private keys agree),
    averages in units of sqrt(N)."""
    ours = read_ours(ours_paths)
    n = len(ours)
    if not n:
        raise ValueError(f"no per-key lines in {', '.join(ours_paths)}")
    s = {"n": n,
         "avg": sum(v[0] for v in ours.values()) / n,
         "dead": sum(v[1] for v in ours.values()) / n,
         "se": mean_se([v[0] for v in ours.values()])[1]}
    if ref_path:
        ref = read_ref(ref_path)
        common = sorted(set(ours) & set(ref))
        if not common:
            raise ValueError(f"no key of ours is in {ref_path}")
        c = len(common)
        s.update(
            common=c,
            ref_avg=sum(ref[k][0] for k in common) / c / REF_SQRT_N,
            ref_dead=sum(ref[k][1] for k in common) / c,
            ours_avg=sum(ours[k][0] for k in common) / c,
            ours_dead=sum(ours[k][1] for k in common) / c,
            ref_se=mean_se([ref[k][0] / REF_SQRT_N for k in common])[1],
            ours_se=mean_se([ours[k][0] for k in common])[1],
            same_priv=sum(ours[k][2] == ref[k][2] for k in common),
        )
        s["ratio"] = s["ours_avg"] / s["ref_avg"]
    return s


def format_summary(s: dict, detail: bool = False) -> str:
    """The lines scripts/stats_summary.py prints; with detail, the
    standard errors and the private-key agreement after them."""
    lines = [f"ours: {s['n']} keys  avg ops = {s['avg']:.3f}*sqrt(N)  "
             f"dead/key = {s['dead']:.2f}"]
    if "common" in s:
        lines += [
            f"common {s['common']} keys:",
            f"  reference: avg {s['ref_avg']:.3f}*sqrt(N)  dead/key "
            f"{s['ref_dead']:.2f}",
            f"  ours:      avg {s['ours_avg']:.3f}*sqrt(N)  dead/key "
            f"{s['ours_dead']:.2f}",
            f"  ratio ours/ref = {s['ratio']:.4f}",
        ]
    if detail and "common" in s:
        d = s["ours_avg"] - s["ref_avg"]
        lines += [
            f"  standard errors: reference {s['ref_se']:.4f}, ours "
            f"{s['ours_se']:.4f}; ours - ref = {d:+.4f} = "
            f"{d / math.hypot(s['ref_se'], s['ours_se']):+.2f} SE",
            f"  private keys equal to the reference's: {s['same_priv']} of "
            f"{s['common']}"]
    elif detail:
        lines.append(f"  standard error {s['se']:.4f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    ref_path = None
    if "--ref" in args:
        i = args.index("--ref")
        if i + 1 >= len(args):
            raise SystemExit("--ref needs a file")
        ref_path = args[i + 1]
        del args[i:i + 2]
    detail = "--detail" in args
    if detail:
        args.remove("--detail")
    if not args:
        raise SystemExit(__doc__)
    print(format_summary(summarize(args, ref_path), detail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
