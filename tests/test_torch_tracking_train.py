"""rodent_walk_imitation through the port's training CLI on the CPU: the
task in --test mode, the reference config rodent_imitation in its --test
cut (the intention networks at their 1024 widths; 8 envs, unroll 10,
batch 32, one iteration) checkpointed, and that checkpoint as the donor
decoder of the three transfer configs (gaps, bowl, generalist): each
trainer restores it, frozen, and its decoder reads as many floats as the
donor's."""

import glob
import os

import pytest
import torch

from flybody_tpu_torch import train_dmpo
from flybody_tpu_torch.io import checkpoint as ckpt

from test_torch_rodent_train import ROOT, _cli

torch.set_num_threads(2)


def test_cli_rodent_walk_imitation():
    """rodent_walk_imitation trains one --test iteration with the plain
    network: 2829 observation floats (the rat's 158, the references' 2670
    and the clip id), 38 actions, 80 updates with a finite critic
    loss."""
    out, line = _cli("--task", "rodent_walk_imitation")
    assert ("task rodent_walk_imitation: 2829 observation floats, 38 "
            "actions, network plain") in out, out
    assert "learner_steps=80" in line, line


@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    """configs/train_config_rodent_imitation.yaml in its --test cut, its
    checkpoint written after the iteration; -> the checkpoint's path."""
    d = str(tmp_path_factory.mktemp("donor"))
    out, line = _cli("--config", "configs/train_config_rodent_imitation"
                     ".yaml", "--ckpt-dir", d, "--ckpt-minutes", "0")
    assert ("task rodent_walk_imitation: 2829 observation floats, 38 "
            "actions, network intention") in out, out
    assert "learner_steps=80" in line and "intention_kl=" in line, line
    path = ckpt.latest(d)
    assert path is not None, glob.glob(os.path.join(d, "*"))
    return path


def _transfer(config, donor, monkeypatch):
    """``config`` (--test sizes, no iteration) with --transfer-ckpt
    ``donor``: -> (the trainer, the train states its restore_decoder
    returned); raises what main raises."""
    built, restored = [], []
    orig = train_dmpo.build_trainer

    def keep(*args):
        tr = orig(*args)
        real = tr.restore_decoder
        tr.restore_decoder = lambda train, d: restored.append(
            real(train, d)) or restored[-1]
        built.append(tr)
        return tr

    monkeypatch.setattr(train_dmpo, "build_trainer", keep)
    try:
        assert train_dmpo.main([
            "--config", os.path.join(ROOT, "configs", f"train_config_"
                                     f"{config}.yaml"),
            "--test", "--device", "cpu", "--iterations", "0",
            "--transfer-ckpt", donor]) == 0
    finally:
        monkeypatch.undo()
    return built[0], restored


def _hold_restored(train, donor, width):
    """Online and target decoders equal the donor's, frozen, reading
    ``width`` floats."""
    want = {k: v for k, v in ckpt.restore_policy_params(donor).items()
            if k.startswith("decoder.")}
    assert len(want) > 0
    for net in (train.policy, train.target_policy):
        got = {k: v for k, v in net.state_dict().items()
               if k.startswith("decoder.")}
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k].to(got[k].dtype)), k
        assert not any(p.requires_grad for p in net.decoder.parameters())
        assert net.decoder.mlp.linears[0].in_features == width


@pytest.mark.parametrize("config", ["gaps_transfer", "bowl_transfer"])
def test_transfer_configs_restore_the_donor(config, donor, monkeypatch):
    """gaps_transfer and bowl_transfer given the imitation run's
    checkpoint by --transfer-ckpt: the online and target decoders equal
    the donor's, parameter for parameter, frozen; they read the intention
    and the rat's 158 egocentric floats, as the donor's does (the rat's
    egocentric observations are the same in the three tasks)."""
    _, restored = _transfer(config, donor, monkeypatch)
    assert len(restored) == 1
    _hold_restored(restored[0], donor, 60 + 158)


def test_generalist_transfer_needs_a_donor_of_its_width(donor, monkeypatch,
                                                         tmp_path):
    """generalist_transfer's multi-task policy reads the union of its four
    tasks' observations, and two-touch's target_pos widens the egocentric
    part to 161 floats: the imitation donor's decoder (158) does not fit,
    so the restore raises before touching the policy (the JAX package's
    graft fails at its first forward pass; ROADMAP C). A donor of that
    width (an intention checkpoint of the generalist's own networks) is
    restored and frozen."""
    with pytest.raises(ValueError, match="does not fit"):
        _transfer("generalist_transfer", donor, monkeypatch)
    own = str(tmp_path / "generalist_donor")
    built = []
    orig = train_dmpo.build_trainer
    monkeypatch.setattr(train_dmpo, "build_trainer",
                        lambda *a: built.append(orig(*a)) or built[-1])
    assert train_dmpo.main([
        "--config", os.path.join(ROOT, "configs",
                                 "train_config_generalist_transfer.yaml"),
        "--test", "--device", "cpu", "--iterations", "0"]) == 0
    monkeypatch.undo()
    ckpt.save(own, {"train": built[0].init(1).train})
    _, restored = _transfer("generalist_transfer", own, monkeypatch)
    _hold_restored(restored[0], own, 60 + 161)
