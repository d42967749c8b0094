#!/usr/bin/env bash
# The PyTorch port's CI, on the CPU: the port's tests (tests/test_torch_*.py,
# which hold it against the reference package), then its four examples with
# --device cpu at reduced flags.  Extra arguments go to pytest.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}

python -m pytest -q tests/test_torch_*.py "$@"

echo "== the port's examples on the CPU =="
python examples/quickstart_torch.py --device cpu
python examples/ehr_analytics_torch.py --device cpu
python examples/serve_demo_torch.py --device cpu --batch 2 --prompt-len 16 \
    --gen 4
python examples/versioned_training_torch.py --device cpu --steps 12 \
    --batch 2 --seq 64
echo "ci_torch OK"
