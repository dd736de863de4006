#!/bin/sh
# usage: sh semseg_torch/tool/train.sh <dataset> <exp_name>
# The port's counterpart of tool/train.sh, the reference's launch convention:
# snapshot code + config into exp/<dataset>/<exp_name>/, run training from the
# snapshot, then test, teeing logs with a timestamp. Run it from the directory
# that holds config/ (the repository root); the config is
# config/<dataset>/<dataset>_<exp_name>.yaml there. What the snapshot holds,
# and where its kernels build, is in _snapshot.sh beside this script. A failed
# training run ends the script with its exit status; otherwise the test run's
# status is the script's.

if [ $# -ne 2 ]; then
    echo "usage: sh semseg_torch/tool/train.sh <dataset> <exp_name>" >&2
    exit 2
fi

dataset=$1
exp_name=$2
exp_dir=exp/${dataset}/${exp_name}
model_dir=${exp_dir}/model
result_dir=${exp_dir}/result
config=config/${dataset}/${dataset}_${exp_name}.yaml
now=$(date +"%Y%m%d_%H%M%S")
. "$(dirname "$0")/_snapshot.sh"

mkdir -p "${model_dir}" "${result_dir}"
snapshot "$(dirname "$0")/.." "${exp_dir}" "${config}" || exit 1

logged "${model_dir}/train-${now}.log" \
    env PYTHONPATH="${exp_dir}" python3 -P -m semseg_torch.train --config="${config}" || exit $?
logged "${result_dir}/test-${now}.log" \
    env PYTHONPATH="${exp_dir}" python3 -P -m semseg_torch.test --config="${config}"
