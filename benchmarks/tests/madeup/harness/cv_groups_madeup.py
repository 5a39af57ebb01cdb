"""A made-up traffic runner of another model family (the fusion
classifier's cross-validation groups), for the contract's tests: the three
hooks a runner has, and nothing that runs a model."""

from benchmarks.harness.common import Outcome


def program_config(conf: dict, seed: int):
    """The program's ``FusionTrainConfig`` of a configuration file."""
    from cervical_tpu_torch.config import FusionTrainConfig
    prog = dict(conf["program"])
    prog["modalities"] = tuple(prog["modalities"])
    return FusionTrainConfig(start_seed=seed, **prog)


def control_readings(ctx) -> dict:
    return {"program": {"loss_gap": 0.0}}


def run(ctx) -> Outcome:
    return Outcome(setup_s=0.0)
