"""A data-parallel CLI run for tests/test_torch_cli.py.

    python -m torch.distributed.run --standalone --nproc_per_node N \
        tests/torch_dp_cli_worker.py OUT CLI [CLI arguments]

runs the CLI's ``main(arguments)`` under torchrun's variables on each
rank and writes ``run_cli``'s record pickled to OUT.<rank>. The test
calls ``run_cli`` in its own process for the one-rank run."""

import importlib.util
import os
import pickle
import sys

from torch.optim.optimizer import register_optimizer_step_pre_hook

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from sparsebit_tpu_torch.parallel import multihost  # noqa: E402


def run_cli(cli, argv):
    """The CLI's ``main(argv)``: {"loss", "state" (numpy), "first_step"}:
    the optimiser's parameters and their gradients (after the dp average)
    as its first step found them, in its order."""
    multihost.TIMEOUT_S = 120  # a hung collective fails the test
    first = []

    def record(optimizer, args, kwargs):
        if not first:
            ps = [p for grp in optimizer.param_groups for p in grp["params"]]
            first.append([(p.detach().numpy().copy(),
                           None if p.grad is None else p.grad.numpy().copy())
                          for p in ps])

    yaml = sys.modules.get("yaml", False)
    sys.modules["yaml"] = None  # the card's machine has no PyYAML
    hook = register_optimizer_step_pre_hook(record)
    try:
        spec = importlib.util.spec_from_file_location("dp_cli", cli)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        res = mod.main(argv)
    finally:
        hook.remove()
        if yaml is False:  # the caller's process imports PyYAML again
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = yaml
    return {"loss": res["loss"],
            "state": {k: v.numpy() for k, v in res["state"].items()},
            "first_step": first[0]}


if __name__ == "__main__":
    out = sys.argv[1]
    rec = run_cli(sys.argv[2], sys.argv[3:])
    with open("{}.{}".format(out, os.environ["RANK"]), "wb") as f:
        pickle.dump(rec, f)
