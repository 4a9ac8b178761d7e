"""A test-side converter from a ``JAXEstimator`` orbax checkpoint to the
port's gathered checkpoint file (the port imports no orbax).

It reads the checkpoint with orbax's ``StandardCheckpointer`` and writes
what :meth:`raydp_tpu_torch.train.Estimator.save` writes: the parameters
through ``params_from_flax``, optax Adam's ``mu``/``nu``/``count`` as
torch Adam's ``exp_avg``/``exp_avg_sq``/``step``, the step and the data
position, and a fresh dropout generator seeded as the port seeds one.
Parameters the port's model has and the JAX model lacks (a classifier's
segment table, never used without segment ids) keep the template's
values and no optimizer state.
"""
import numpy as np
import torch

from raydp_tpu_torch.models.convert import params_from_flax


def convert_orbax_checkpoint(path: str, out_path: str, cfg, template_model,
                             template_optimizer, seed: int = 0) -> str:
    import orbax.checkpoint as ocp

    raw = ocp.StandardCheckpointer().restore(path)
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else np.asarray(v)
                      for k, v in t.items()}
    params = params_from_flax(tree(raw["params"]["params"]), cfg)
    adam = raw["opt_state"][0]
    mu = params_from_flax(tree(adam["mu"]["params"]), cfg)
    nu = params_from_flax(tree(adam["nu"]["params"]), cfg)
    count = float(np.asarray(adam["count"]))
    model = {**template_model.state_dict(), **params}
    names = [n for n, _ in template_model.named_parameters()]
    state = {i: {"step": torch.tensor(count), "exp_avg": mu[n],
                 "exp_avg_sq": nu[n]}
             for i, n in enumerate(names) if n in mu}
    optimizer = {"state": state,
                 "param_groups": template_optimizer.state_dict()[
                     "param_groups"]}
    torch.save({
        "model": model,
        "optimizer": optimizer,
        "step": int(np.asarray(raw["step"])),
        "data_epoch": int(np.asarray(raw["data_epoch"])),
        "data_batch": int(np.asarray(raw["data_batch"])),
        "data_world": int(np.asarray(raw["data_world"])),
        "generator": torch.Generator().manual_seed(seed + 1).get_state(),
    }, out_path)
    return out_path
