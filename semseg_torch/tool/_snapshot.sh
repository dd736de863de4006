# Sourced by train.sh and test.sh (not run alone): the snapshot and the
# teed logs the two launch scripts share.
#
# snapshot <pkg> <exp_dir> <config>: replace <exp_dir>/semseg_torch with the
# package's sources at <pkg> (*.py, csrc/*.cu and these scripts; no
# __pycache__, no build/), copy the native loader's csrc/hostpipe.cpp beside
# it where present, and the config into <exp_dir>. The scripts run Python
# with -P, so that the snapshot's package is imported and not one in the
# working directory. The snapshot's CUDA kernels build at first use under
# <exp_dir>/build/semseg_torch_kernels/ (ops/_build.py puts BUILD_DIR beside
# the package): each experiment builds once (about 10 s of nvcc), inside
# exp/, which .gitignore lists.
snapshot() {
    pkg=$1
    exp_dir=$2
    config=$3
    rm -rf "${exp_dir}/semseg_torch"
    mkdir -p "${exp_dir}/semseg_torch"
    (cd "${pkg}" && find . \( -name __pycache__ -o -name build \) -prune -o -type f \
        \( -name '*.py' -o -name '*.cu' -o -name '*.sh' \) -print | tar -cf - -T -) \
        | (cd "${exp_dir}/semseg_torch" && tar -xf -) || return 1
    if [ -f "${pkg}/../csrc/hostpipe.cpp" ]; then
        mkdir -p "${exp_dir}/csrc"
        cp "${pkg}/../csrc/hostpipe.cpp" "${exp_dir}/csrc/"
    fi
    cp "${config}" "${exp_dir}"
}

# logged <log> <command...>: run the command with its output teed to <log>;
# return the command's status.
logged() {
    log=$1
    shift
    { "$@" 2>&1; echo $? > "${log}.rc"; } | tee "${log}"
    rc=$(cat "${log}.rc")
    rm -f "${log}.rc"
    return "${rc}"
}
