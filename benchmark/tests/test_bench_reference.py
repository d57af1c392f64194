"""The plain reference agrees with the port at tiny sizes on the CPU
(where the port runs its kernels' plain versions), and the controls
(one precision step lower) read far from it."""

import torch

from benchmark.lib import weights
from benchmark.lib.train import initial_adapters
from benchmark.reference.decoder import (
    ServeReference,
    TrainReference,
    dequant,
    forward_product,
)
from benchmark.tests.conftest import tiny_chat, tiny_qlora

CPU = torch.device("cpu")


def _serve_ref(mc, maker, bits):
    stacks = maker.stacks()
    return ServeReference(mc, maker.layer_weights(stacks), maker.embed(),
                          maker.head(), maker.norms(), maker.gs,
                          act_bits=bits, kv_bits=bits)


def test_prefill_and_decode_logits_match_the_port(cpu_threads):
    from sparsebit_tpu_torch.llm.decode import prefill_at
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
    from sparsebit_tpu_torch.llm.serving import DecodeEngine

    mc, _ = tiny_chat()
    maker = weights.Maker(mc, 2 ** 31 + 9, CPU)
    cfg = weights.llama_config(mc)
    params = weights.serving_params(maker)
    prompt = torch.randint(0, mc["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(5))
    cache = init_kv_cache(cfg, 1, 64, True, device=CPU)
    logits, _ = prefill_at(params, prompt, cache, cfg,
                           torch.tensor([39], dtype=torch.int32),
                           torch.tensor([0], dtype=torch.int32))
    eng = DecodeEngine(params, cfg, max_batch=2, max_len=128, chunk=4,
                       device=CPU)
    eng.add_request(prompt[0].numpy(), max_new_tokens=12)
    served = next(iter(eng.run().values()))
    ref = _serve_ref(mc, maker, 8).logits(
        [torch.cat([prompt[0], torch.tensor(served[:-1])])], [39])[0]
    scale = float(ref.std())
    diff = float((logits[0] - ref[0]).abs().max())
    print("prefill logits: worst difference", diff, "of sd", scale)
    assert diff < 0.1 * scale
    gaps = ref.max(dim=-1).values - ref.gather(
        1, torch.tensor(served)[:, None])[:, 0]
    print("served tokens: widest gap", float(gaps.max()))
    assert float(gaps.max()) < 0.1 * scale
    low = _serve_ref(mc, maker, 4).logits(
        [torch.cat([prompt[0], torch.tensor(served[:-1])])], [39])[0]
    print("control: worst difference", float((low - ref).abs().max()))
    assert float((low - ref).abs().max()) > 4 * diff


def _program_grads(mc, tokens, seed):
    from sparsebit_tpu_torch.llm import qlora as Q

    maker = weights.Maker(mc, seed, CPU)
    params = weights.training_params(maker)
    lora = initial_adapters(mc, seed, CPU)
    # a nonzero B, so that A's gradient is not nought
    g = torch.Generator().manual_seed(3)
    for d in lora.values():
        d["lora_B"] = torch.randn(d["lora_B"].shape, generator=g) * 0.05
    layers = []
    for li, layer in enumerate(params["layers"]):
        layer = dict(layer)
        for name in mc["qlora"]["targets"]:
            d = lora[(li, name)]
            layer[name] = Q.LoraLinear(layer[name], d["lora_A"], d["lora_B"],
                                       mc["qlora"]["alpha"])
        layers.append(layer)
    p = Q.prepare_train(dict(params, layers=layers))
    Q.lora_parameters(lora)
    loss = Q.qlora_loss_fn(lora, p, tokens, weights.llama_config(mc))
    loss.backward()
    grads = {(li, n, ab[-1]): d[ab].grad for (li, n), d in lora.items()
             for ab in ("lora_A", "lora_B")}
    return float(loss.detach()), grads, lora, maker


def test_qlora_loss_and_gradients_match_the_port(cpu_threads):
    mc, tr = tiny_qlora()
    tokens = torch.randint(0, mc["vocab_size"], (4, 33),
                           generator=torch.Generator().manual_seed(1))
    loss, grads, lora, maker = _program_grads(mc, tokens, 77)
    stacks = maker.stacks()

    def get_w(key):
        li, name = key
        return dequant(*(t[li] for t in stacks[name]), maker.gs)

    out = {}
    for mode in ("f32", "fp8"):
        ref = TrainReference(mc, get_w, maker.embed(), maker.head(),
                             maker.norms(), mc["qlora"]["alpha"], mode)
        pairs = {k: (d["lora_A"].detach().clone().requires_grad_(),
                     d["lora_B"].detach().clone().requires_grad_())
                 for k, d in lora.items()}
        r_loss = ref.loss(tokens, pairs)
        leaves = [t for ab in pairs.values() for t in ab]
        r_grads = dict(zip([(li, n, x) for (li, n) in pairs for x in "AB"],
                           torch.autograd.grad(r_loss, leaves)))
        out[mode] = (float(r_loss), r_grads)
    r_loss, r_grads = out["f32"]
    assert abs(loss - r_loss) < 1e-3 * abs(r_loss)
    worst = max(float((grads[k] - r_grads[k]).norm() / r_grads[k].norm())
                for k in grads)
    fp8 = max(float((out["fp8"][1][k] - r_grads[k]).norm()
                    / r_grads[k].norm()) for k in grads)
    print("adapter gradients, worst leaf's relative difference: program",
          worst, "fp8-input control", fp8)
    assert worst < 0.05
    assert fp8 > 3 * worst


def test_frozen_cache_fault_moves_decode_positions_only(cpu_threads):
    mc, _ = tiny_chat()
    maker = weights.Maker(mc, 2 ** 31 + 3, CPU)
    stacks = maker.stacks()
    seq = torch.randint(0, mc["vocab_size"], (48,),
                        generator=torch.Generator().manual_seed(2))
    out = {}
    for frozen in (False, True):
        ref = ServeReference(mc, maker.layer_weights(stacks), maker.embed(),
                             maker.head(), maker.norms(), maker.gs,
                             frozen=frozen)
        out[frozen] = ref.logits([seq], [30])[0]
    # position 30 is the prompt's last (its own rows only); the decode
    # positions after it lose the served tokens' rows
    assert torch.equal(out[True][0], out[False][0])
    assert float((out[True][1:] - out[False][1:]).abs().max()) > 1e-3


def test_forward_modes_round_their_operands():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(64, 256, generator=g).to(torch.bfloat16)
    W = torch.randn(256, 128, generator=g) * 0.05
    exact = forward_product(x, W, "f32")
    bf16 = forward_product(x, W, "bf16")
    fp8 = forward_product(x, W, "fp8")
    assert torch.equal(bf16, x.float() @ W.to(torch.bfloat16).float())
    e_bf16 = float((bf16 - exact).norm() / exact.norm())
    e_fp8 = float((fp8 - exact).norm() / exact.norm())
    # bf16 keeps 8 bits of W, e4m3 4
    assert 5e-4 < e_bf16 < 5e-3
    assert e_fp8 > 8 * e_bf16
