"""Reproduce the paper's tables from the port's ECM implementation.

Prints (a) the §3 IvyBridge walk-through (naive/scalar/SSE/AVX predictions,
saturation points, Eq. 2) and (b) Table 2 across SNB/IVB/HSW/BDW, line for
line as ``examples/reproduce_paper.py`` does, and (c) the H100 table of the
port's dot (B1) and sum (B3) kernels for every built-in scheme at the
paper's n = 2^27 float32 and U = 1, 2, 4, 8, 16: the predicted ms, the term
that bounds it, the bytes bound and the saturation U. Runs on the CPU; no
card and no kernel build is needed.

    PYTHONPATH=src python examples/reproduce_paper_torch.py
"""

from repro_torch.core import ecm

PAPER_N = 1 << 27
SCHEMES = ("naive", "kahan", "pairwise", "dot2")


def main():
    print("=" * 72)
    print("(a) Paper §3: IvyBridge, single precision")
    print("=" * 72)
    rows = [
        ("naive (AVX, compiler)", ecm.NAIVE_SP),
        ("Kahan scalar", ecm.KAHAN_SCALAR_SP),
        ("Kahan SSE", ecm.KAHAN_SSE_SP),
        ("Kahan AVX", ecm.KAHAN_AVX_SP),
        ("Kahan scalar (DP)", ecm.KAHAN_SCALAR_DP),
    ]
    for name, kern in rows:
        r = ecm.ecm_x86(ecm.IVB, kern)
        print(f"{name:22s} ECM {r.shorthand():34s} -> {r.pred_shorthand():26s}"
              f" P={r.perf_gups} GUP/s  n_s={r.n_s}")
    print("\npaper Eq. 2: P = {8.80 | 4.40 | 2.93 | 1.68} GUP/s "
          "(naive, IVB) — matches row 1")

    print()
    print("=" * 72)
    print("(b) Paper Table 2: optimal AVX Kahan across four Xeon generations")
    print("=" * 72)
    for m in (ecm.SNB, ecm.IVB, ecm.HSW, ecm.BDW):
        r = ecm.ecm_x86(m, ecm.KAHAN_AVX_SP)
        print(f"{m.name}: ECM {r.shorthand():36s} pred {r.pred_shorthand():26s}"
              f" perf {r.perf_gups} GUP/s")

    print()
    print("=" * 72)
    m = ecm.H100
    print(f"(c) {m.name}: B1 (dot) and B3 (sum), n = 2^27 float32, "
          f"{m.clock_mhz:.0f} MHz, b_S {m.load_gbs:.0f} GB/s")
    print("=" * 72)
    print(f"{'op':4s} {'scheme':9s} {'U':>3s} {'CTAs':>5s} {'SMs':>4s} "
          f"{'pred ms':>8s} {'bound':6s} {'bytes ms':>8s} {'u_s':>4s}")
    for op in ("dot", "sum"):
        for name in SCHEMES:
            for unroll in ecm.UNROLLS:
                r = ecm.ecm_gpu_for_scheme(m, name, PAPER_N, unroll, op=op)
                print(f"{op:4s} {name:9s} {unroll:3d} {r.ctas:5d} "
                      f"{r.sms_used:4d} {r.pred_ms:8.4f} {r.bound:6s} "
                      f"{r.bytes_bound_ms:8.4f} {str(r.u_s):>4s}")
    print("-> compensation is free wherever the bytes bound both the scheme "
          "and naive\n   at the same U; below u_s the chains (or their "
          "issue slots) bound it.")


if __name__ == "__main__":
    main()
