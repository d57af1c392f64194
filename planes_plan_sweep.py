"""Sweep the launch plans of K6/K7/K8 (csrc/quant_matmul_planes.cu) at
LLaMA-7B shapes on the card: for each plan (rows a thread MR, byte columns
a block CB, groups a K split gps), the device ms of one call from a
CUDA-graph replay of 20 calls over 8 weight copies (chip_smoke.graph_ms),
and whether it agrees with the plain version within 1e-4 of max |out|.
The plan that ops/quant_matmul.planes_plan ships is always among those
timed. Run it from the root of the repo on a machine with one GPU:

    python planes_plan_sweep.py

It prints the card's name and power limit, then one line a shape: the
shipped plan's time and the four fastest plans.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as C  # noqa: E402
from sparsebit_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant  # noqa: E402

SHAPES = ((4, 4096, 11008, (1, 8, 64)), (4, 11008, 4096, (1, 8, 64)),
          (3, 4096, 11008, (8, 64)), (2, 4096, 11008, (8,)),
          (8, 4096, 11008, (8,)))
COPIES = 8


def candidates(bits, M, G, shipped):
    """Plans of 256 threads that cover M rows, at most 64 accumulators a
    thread, and the shipped plan."""
    P = 8 if bits == 3 else (1 if bits == 8 else 8 // bits)
    plans = {shipped}
    for MR in (1, 2, 4, 8):
        if MR * P > 64 or MR > max(1, M) * 2:
            continue
        RG = 1
        while RG * MR < M:
            RG *= 2
        CB = QM.PLANES_THREADS // RG
        if CB < 16:
            continue
        for gps in (1, 2, 4, 8, 16, 32, 64, 86):
            if gps <= G:
                plans.add((MR, CB, gps, -(-G // gps)))
    return sorted(plans)


def main():
    if not torch.cuda.is_available():
        sys.exit("planes_plan_sweep.py needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shipped_plan = QM.planes_plan
    print(C.card_line(), flush=True)
    for bits, K, N, Ms in SHAPES:
        lin = C.random_plane_linear(K, N, bits, g, dev, copies=COPIES)
        Np, gs = lin.n_padded, 128
        pk = [{k: v[i] for k, v in lin.packed.items()}
              for i in range(COPIES)]
        for a8 in (False, True):
            for M in Ms:
                x = torch.randn((M, K), generator=g, device=dev)
                if a8:
                    x = tokenwise_quant(x)[0]

                def run(i):
                    c = i % COPIES
                    s, z = lin.scales[c], lin.zeros[c]
                    if bits == 3:
                        return QM.quant_matmul_3bit(x, pk[c], s, z, gs, Np,
                                                    a8=a8)
                    fn = QM.quant_matmul_w_a8 if a8 else QM.quant_matmul_w
                    return fn(x, pk[c]["w"], s, z, bits, gs, Np)

                ref = QM._qmm_planes_plain(x, pk[0], lin.scales[0],
                                           lin.zeros[0], bits, gs, Np)
                tol = 1e-4 * ref.abs().max().item()
                shipped = shipped_plan(bits, M, K, Np, gs, sms)
                res = []
                for plan in candidates(bits, M, K // gs, shipped):
                    QM.planes_plan = lambda *a, _p=plan: _p
                    try:
                        ok = (run(0) - ref).abs().max().item() <= tol
                        res.append((C.graph_ms(run, 20), plan, ok))
                    except RuntimeError as e:
                        print("plan", plan, "failed:", e, flush=True)
                    finally:
                        QM.planes_plan = shipped_plan
                res.sort(key=lambda r: r[0])
                mine = [r for r in res if r[1] == shipped]
                print("{}-bit {} M={} {}->{}: shipped {} {} ms; fastest {}"
                      .format(bits, "int8" if a8 else "f32", M, K, N,
                              shipped,
                              "{:.4f}".format(mine[0][0]) if mine
                              else "failed",
                              ", ".join("{} {:.4f}{}".format(
                                  p, t, "" if ok else " DISAGREES")
                                  for t, p, ok in res[:4])), flush=True)
        del lin, pk
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
