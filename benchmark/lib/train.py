"""The training loop: the program's ``qlora_train_step`` back to back.

Set-up builds the one training object (the frozen INT4 backbone with
``prepare_train``'s int8 W^T, the f32 adapters, AdamW) and drives it
through its first ``check_steps`` steps with the window's own call and
feed; those steps are the warm-up, and what they did is kept for the
check: each step's loss, the first gradient as AdamW holds it after one
step (its first moment over 1 - beta1), and each adapter's change after
the last of them. The window then runs whole steps until ``seconds``
have passed.
"""

import time


def _leaves(lora):
    return {(li, name, ab[-1]): t for (li, name), d in lora.items()
            for ab, t in (("lora_A", d["lora_A"]), ("lora_B", d["lora_B"]))}


def build(ctx):
    """The program's training object for ctx's config and seed: (params
    prepared for training, the adapters {(layer, name): {"lora_A",
    "lora_B"}}, the optimiser, the program's LlamaConfig)."""
    import torch

    from benchmark.lib import weights
    from sparsebit_tpu_torch.llm import qlora as Q

    mc, dev = ctx.mc, ctx.device
    q = mc["qlora"]
    maker = weights.Maker(mc, ctx.seed, dev)
    params = weights.training_params(maker)
    lora = initial_adapters(mc, ctx.seed, dev)
    layers = []
    for li, layer in enumerate(params["layers"]):
        layer = dict(layer)
        for name in q["targets"]:
            d = lora[(li, name)]
            layer[name] = Q.LoraLinear(layer[name], d["lora_A"],
                                       d["lora_B"], q["alpha"])
        layers.append(layer)
    params = Q.prepare_train(dict(params, layers=layers))
    opt = Q.adamw(lora, q["lr"], weight_decay=q["weight_decay"])
    for group in opt.param_groups:
        if tuple(group["betas"]) != tuple(q["betas"]) or \
                group["eps"] != q["eps"]:
            raise ValueError("the program's AdamW is not the configuration's")
    return params, lora, opt, weights.llama_config(mc)


def initial_adapters(mc, seed, device):
    """The adapters as the benchmark makes them for both sides: A ~ N(0,
    1/K) (one draw a target over the layer stack), B = 0."""
    import torch

    from benchmark.lib.weights import linear_shapes, sub_seed

    q, L = mc["qlora"], mc["num_hidden_layers"]
    shapes = linear_shapes(mc, q["targets"])
    out = {}
    for name in q["targets"]:
        K, N = shapes[name]
        g = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "lora_A." + name))
        A = torch.randn((L, K, q["r"]), generator=g, device=device) * K ** -0.5
        for li in range(L):
            out[(li, name)] = {
                "lora_A": A[li].clone(),
                "lora_B": torch.zeros((q["r"], N), device=device)}
    return out


def run(ctx):
    """Set up (with the checked steps), then measure; fills ``ctx`` and
    returns the check's inputs: (the checked batches, the initial
    adapters {leaf: tensor}, losses, first gradients {leaf: tensor},
    adapters after the checked steps {leaf: tensor})."""
    import torch

    from benchmark.lib.trace import Tracer
    from benchmark.lib.traffic import Batches
    from sparsebit_tpu_torch.llm import qlora as Q

    spec, dev = ctx.traffic, ctx.device
    params, lora, opt, cfg = build(ctx)
    step_fn = ctx.faults.get("train_step", Q.qlora_train_step)
    feed = Batches(spec, ctx.seed, ctx.mc["vocab_size"], dev)
    leaves = _leaves(lora)
    lora0 = {k: t.detach().clone() for k, t in leaves.items()}
    b1 = ctx.mc["qlora"]["betas"][0]
    batches, losses, first = [], [], None
    for i in range(spec["check_steps"]):
        tokens = feed.next()
        batches.append(tokens.clone())
        with ctx.spans("train_step"):
            lora, loss = step_fn(lora, opt, params, tokens, cfg)
        losses.append(float(loss))
        if i == 0:
            first = {k: opt.state[t]["exp_avg"] / (1 - b1)
                     if t in opt.state else torch.zeros_like(t)
                     for k, t in leaves.items()}
    after = {k: t.detach().clone() for k, t in leaves.items()}
    ctx.sync()
    ctx.open_window()
    steps, n_bad = [], 0
    with Tracer(ctx.traced and dev.type == "cuda") as tr:
        t0 = time.perf_counter()
        while True:
            with ctx.spans("feed"):
                tokens = feed.next()
            t_a = time.perf_counter()
            with ctx.spans("train_step"):
                lora, loss = step_fn(lora, opt, params, tokens, cfg)
                value = float(loss)
            t_b = time.perf_counter()
            steps.append((t_a, t_b, tokens.shape[0] * (tokens.shape[1] - 1)))
            n_bad += not torch.isfinite(torch.tensor(value))
            if t_b >= t0 + ctx.seconds:
                break
    ctx.close_window(t0, t_b, tr.ops)
    ctx.memory_peak()
    ctx.steps = steps
    ctx.attempted, ctx.failed = len(steps), int(n_bad)
    ctx.work["train"] = len(steps)
    del params, lora, opt
    return batches, lora0, losses, first, after


def reference(ctx, batches, lora0, forward="f32"):
    """The plain reference's checked steps from the same start: (losses,
    first gradients, adapters after, the largest gradient norm of each
    leaf over the steps)."""
    from benchmark.lib import weights
    from benchmark.reference.decoder import TrainReference, dequant

    mc = ctx.mc
    q = mc["qlora"]
    maker = weights.Maker(mc, ctx.seed, ctx.device)
    stacks = maker.stacks()

    def get_w(key):
        li, name = key
        c, s, z = (t[li] for t in stacks[name])
        return dequant(c, s, z, maker.gs)

    ref = TrainReference(mc, get_w, maker.embed(), maker.head(),
                         maker.norms(), q["alpha"], forward=forward)
    pairs = {(li, name): (lora0[(li, name, "A")], lora0[(li, name, "B")])
             for (li, name, ab) in lora0 if ab == "A"}
    out = ref.steps(batches, pairs, q["lr"], tuple(q["betas"]), q["eps"],
                    q["weight_decay"])
    del stacks
    return out
