#!/usr/bin/env bash
# Launch wrapper of the PyTorch port: the hygiene that must be in place
# BEFORE the python interpreter execs, the pair of launch/env.py, which
# handles the in-process half (log levels, the default dtype).
#
#   src/repro_torch/launch/run.sh serve --reduced --continuous ...
#   src/repro_torch/launch/run.sh train --reduced --steps 20 ...
#   REPRO_ENTRY=module.path src/repro_torch/launch/run.sh -- <args>
#
# Everything uses ":-" defaults: an operator's exported value wins.
set -euo pipefail

# -- tcmalloc: the linker reads LD_PRELOAD at exec time, so this is the
#    one knob launch/env.py cannot set.  glibc malloc fragments under
#    multi-GB host copies (checkpoints); preload tcmalloc when present.
if [[ -z "${LD_PRELOAD:-}" ]]; then
  for so in /usr/lib/x86_64-linux-gnu/libtcmalloc.so.4 \
            /usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4 \
            /usr/lib/libtcmalloc.so.4; do
    if [[ -e "$so" ]]; then
      export LD_PRELOAD="$so"
      break
    fi
  done
fi
# silence tcmalloc's >1GB allocation reports (weights trip it)
export TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD="${TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD:-60000000000}"

# -- log + dtype hygiene (env.py setdefaults these too; exporting here
#    covers what starts before main(): c10 reads its log level at import)
export TORCH_CPP_LOG_LEVEL="${TORCH_CPP_LOG_LEVEL:-ERROR}"
export NCCL_DEBUG="${NCCL_DEBUG:-WARN}"
export REPRO_TORCH_DEFAULT_DTYPE="${REPRO_TORCH_DEFAULT_DTYPE:-float32}"

# JAX's wrapper also appends XLA's step-marker flag on a TPU host; there
# is no XLA between the port and the card, so that block has no
# counterpart here.

entry="${REPRO_ENTRY:-}"
if [[ -z "$entry" ]]; then
  cmd="${1:-serve}"
  case "$cmd" in
    serve|train) entry="repro_torch.launch.$cmd"; [[ $# -eq 0 ]] || shift ;;
    --) entry="repro_torch.launch.serve"; shift ;;
    *)  entry="repro_torch.launch.serve" ;;
  esac
else
  [[ "${1:-}" == "--" ]] && shift
fi

if [[ -n "${REPRO_RUN_DRY:-}" ]]; then
  # print what would run, and stop (the tests' entry resolution check)
  echo "python -m $entry${*:+ $*}"
  exit 0
fi
exec python -m "$entry" "$@"
