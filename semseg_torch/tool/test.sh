#!/bin/sh
# usage: sh semseg_torch/tool/test.sh <dataset> <exp_name>
# The port's counterpart of tool/test.sh: snapshot code + config into
# exp/<dataset>/<exp_name>/ as semseg_torch/tool/train.sh does (_snapshot.sh
# beside this script), then test from the snapshot, teeing the log with a
# timestamp. The script's status is the test run's.

if [ $# -ne 2 ]; then
    echo "usage: sh semseg_torch/tool/test.sh <dataset> <exp_name>" >&2
    exit 2
fi

dataset=$1
exp_name=$2
exp_dir=exp/${dataset}/${exp_name}
result_dir=${exp_dir}/result
config=config/${dataset}/${dataset}_${exp_name}.yaml
now=$(date +"%Y%m%d_%H%M%S")
. "$(dirname "$0")/_snapshot.sh"

mkdir -p "${result_dir}"
snapshot "$(dirname "$0")/.." "${exp_dir}" "${config}" || exit 1

logged "${result_dir}/test-${now}.log" \
    env PYTHONPATH="${exp_dir}" python3 -P -m semseg_torch.test --config="${config}"
