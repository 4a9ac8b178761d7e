#!/usr/bin/env bash
# Time `import torch` and `import torch._dynamo` (which building a torch
# optimizer imports) in fresh interpreters: without a bytecode cache (as
# the process's environment has it), then with one in a prefix directory
# written by a first process, alone and four at once. Prints one line a
# process. Run it on the machine under study:
#   bash scripts/import_probe.sh
set -u
T='import sys, time; t = time.time(); import torch; t1 = time.time(); import torch._dynamo; t2 = time.time(); print(f"{sys.argv[1]}: torch {t1 - t:.2f} dynamo {t2 - t1:.2f} dont_write_bytecode {sys.flags.dont_write_bytecode}")'
echo "PYTHONDONTWRITEBYTECODE=${PYTHONDONTWRITEBYTECODE-}"
for i in 1 2; do python3 -c "$T" plain; done
PREFIX=$(mktemp -d)
python3 -c "import sys; sys.dont_write_bytecode = False; sys.pycache_prefix = '$PREFIX'; $T" writes-cache
for i in 1 2; do env -u PYTHONDONTWRITEBYTECODE PYTHONPYCACHEPREFIX="$PREFIX" python3 -c "$T" cached; done
for i in 1 2 3 4; do env -u PYTHONDONTWRITEBYTECODE PYTHONPYCACHEPREFIX="$PREFIX" python3 -c "$T" cached-4-at-once & done
wait
for i in 1 2 3 4; do python3 -c "$T" plain-4-at-once & done
wait
rm -rf "$PREFIX"
