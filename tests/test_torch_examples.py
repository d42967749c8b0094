"""The repo's four examples on the port, their output held to the
reference's committed transcripts (``tests/data/examples/``).

``examples/{quickstart,ehr_analytics}_torch.py`` must print the reference's
transcript byte for byte.  ``examples/{serve_demo,versioned_training}_torch.py``
must print it line for line outside the named masks of
``tests/data/examples/masks.json`` (each with its reason): wall-clock
seconds, and the numbers that come from the random weights, which the
reference draws from ``jax.random.PRNGKey(0)`` and the port from a seeded
``torch.Generator``.  The numeric equality of those two flows on shared
weights is held elsewhere: the registry's restores and served tokens by
``tests/test_torch_serve.py::test_model_registry_restores_and_serves``, the
train step, checkpointer and resume by ``tests/test_torch_train_system.py``.

Each case runs the reference example too, against the same transcript, so
that a transcript that no longer matches the reference fails here.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest

from chip_smoke import EXAMPLES_DATA as DATA
from chip_smoke import ROOT, load_example, masked

with open(os.path.join(DATA, "masks.json")) as _f:
    MASKS = json.load(_f)


def transcript(name: str) -> str:
    with open(os.path.join(DATA, name + ".txt")) as f:
        return f.read()


def run_pair(ref_argv, port_argv):
    """The reference's and the port's example, side by side in two
    processes → their stdouts."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for argv in (ref_argv, port_argv)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    return outs


@pytest.mark.parametrize("example", ["quickstart", "ehr_analytics"])
def test_store_example_prints_the_reference_transcript(example):
    want = transcript(example)
    ref, port = run_pair([f"examples/{example}.py"],
                         [f"examples/{example}_torch.py", "--device", "cpu"])
    assert ref == want
    assert port == want


@pytest.mark.parametrize("example,name", [
    (e, n) for e in sorted(MASKS) for n in sorted(MASKS[e])])
def test_every_mask_hides_a_field_of_its_transcript(example, name):
    """A mask that hides nothing would be dead weight: each one matches a
    field of the reference's transcript of its example."""
    pattern = MASKS[example][name]["pattern"]
    runs = [f for f in os.listdir(DATA) if f.startswith(example)]
    assert runs and all(re.search(pattern, transcript(f[:-4]))
                        for f in runs)


def test_serve_demo_matches_the_reference_outside_its_masks():
    flags = ["--batch", "2", "--prompt-len", "16", "--gen", "4"]
    want = masked(transcript("serve_demo_batch2_prompt16_gen4"), "serve_demo")
    ref, port = run_pair(["examples/serve_demo.py", *flags],
                         ["examples/serve_demo_torch.py", *flags,
                          "--device", "cpu"])
    assert masked(ref, "serve_demo") == want
    assert masked(port, "serve_demo") == want


def test_versioned_training_matches_the_reference_outside_its_masks(
        monkeypatch):
    """The example hard-codes smollm-360m at depth 8; its ``.reduced()``
    config stands in for it in both packages' ``ARCHS``, so that the run is
    small."""
    import repro.configs
    import repro_torch.configs
    for arches in (repro.configs.ARCHS, repro_torch.configs.ARCHS):
        monkeypatch.setitem(arches, "smollm-360m",
                            arches["smollm-360m"].reduced())
    flags = ["--steps", "12", "--batch", "2", "--seq", "64"]
    want = masked(transcript("versioned_training_reduced_steps12_batch2_seq64"),
                  "versioned_training")
    outs = []
    for file, argv in (("versioned_training.py", flags),
                       ("versioned_training_torch.py",
                        flags + ["--device", "cpu"])):
        mod = load_example(file)
        monkeypatch.setattr(sys, "argv", [file, *argv])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert masked(outs[0], "versioned_training") == want
    assert masked(outs[1], "versioned_training") == want
