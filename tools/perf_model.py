"""Analytical speed-of-light model for the flagship frame program.

Counts, per pipeline stage, the device-memory bytes and the elementwise
integer operations the algorithm needs at an operating point (default
1280x720, D=128, SGM 8-path, block_size=5), and divides them by the peaks
of the named device. The larger of the two quotients is that stage's
floor. Counts assume perfect fusion and overlap, so the model is a ceiling
no implementation can beat; it is not a measurement.

Peaks are keyed by `jax.devices()[0].device_kind`; a kind missing from
PEAKS is an error, never a default.

Usage: python tools/perf_model.py [WxH] [D] [paths] [--device-kind KIND]
"""

import math
import sys

# NVIDIA H100 SXM5 data sheet: 3.35 TB/s HBM3, 67 TFLOP/s FP32 outside
# the tensor cores. An SM issues INT32 at half its FP32 rate (64 vs 128
# lanes per clock), hence 33.5e12 integer ops/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "int_ops_per_s": 33.5e12},
}


def peaks_for(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peaks recorded for device kind {device_kind!r}; add its "
            f"data-sheet values to PEAKS") from None


def stage(name, peaks, nbytes, int_ops=0, verbose=True):
    t_mem = nbytes / peaks["bytes_per_s"] * 1e3
    t_ops = int_ops / peaks["int_ops_per_s"] * 1e3
    t = max(t_mem, t_ops)
    if verbose:
        bound = "memory" if t_mem >= t_ops else "int-ops"
        print(f"  {name:<34} {t_mem:7.3f} {t_ops:7.3f} -> {t:7.3f} ms "
              f"({bound}-bound)")
    return t


def floor_ms(W, H, D, paths=8, device_kind="NVIDIA H100 80GB HBM3",
             verbose=False):
    """Speed-of-light frame time (ms) at (W, H, D, paths) on device_kind."""
    peaks = peaks_for(device_kind)
    W1 = W - D
    vol = H * W1 * D            # cost-volume elements
    px = H * W
    if verbose:
        print(f"{W}x{H} D={D} W1={W1} paths={paths} on {device_kind} "
              f"(columns: memory / int-op floor, ms)")
    total = 0.0
    # rectify: 2 gathers (packed gray+RGB left, gray right) of uint8 planes
    total += stage("rectify remap", peaks, 5 * px * 2, px * 40, verbose)
    # BT cost volume: int16 out once; BT ~14 ops + 2 * bs window adds
    total += stage("BT cost volume (int16 out)", peaks,
                   12 * px * 4 + vol * 2, vol * (14 + 10), verbose)
    # aggregation: per direction read C (int16) + read/write S (int32);
    # the first direction writes S only. ~8 ops per element per direction.
    agg_bytes = paths * vol * 2 + (2 * paths - 1) * vol * 4
    total += stage(f"SGM aggregation ({paths} directions)", peaks,
                   agg_bytes, paths * vol * 8, verbose)
    # WTA + uniqueness + subpixel: one read of S, ~6 ops per element
    total += stage("WTA + uniqueness + subpixel", peaks,
                   vol * 4 + 4 * H * W1 * 4, vol * 6, verbose)
    # LR check: 2 shift-reduces over D+2 candidates of (H, W) planes
    total += stage("LR consistency", peaks, 6 * px * 4,
                   2 * px * 3 * (D + 2), verbose)
    # speckle: CC propagation ~3 sweeps of segmented scans + sizes
    cc_ops = 3 * px * (math.ceil(math.log2(W)) * 4 + 16)
    total += stage("speckle (CC + sizes)", peaks, 6 * px * 4, 2 * cc_ops,
                   verbose)
    total += stage("hsv+inrange+morph open/close", peaks, 4 * px * 2,
                   px * (20 + 4 * 12), verbose)
    total += stage("detect + reproject + depth", peaks, 6 * px * 4,
                   2 * cc_ops + px * 20, verbose)
    return total


def main():
    argv = list(sys.argv[1:])
    kind = "NVIDIA H100 80GB HBM3"
    if "--device-kind" in argv:
        i = argv.index("--device-kind")
        kind = argv[i + 1]
        del argv[i : i + 2]
    W, H = (int(v) for v in (argv[0] if argv else "1280x720").split("x"))
    D = int(argv[1]) if len(argv) > 1 else 128
    paths = int(argv[2]) if len(argv) > 2 else 8
    total = floor_ms(W, H, D, paths, kind, verbose=True)
    print(f"  {'TOTAL (no overlap between stages)':<34} {'':7} {'':7} -> "
          f"{total:7.3f} ms = {1e3 / total:6.1f} fps ceiling")
    return total


if __name__ == "__main__":
    main()
