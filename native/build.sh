#!/bin/sh
# Build the native host module.  Run from anywhere; output lands next to
# the source as libicon_host.so.  Flags match icon_dvr/utils/native.py
# CXX_FLAGS (no -march=native: the binary runs on whatever x86-64 host the
# checkout is copied to; -ffp-contract=off keeps the oracle parity).
set -e
cd "$(dirname "$0")"
g++ -O3 -ffp-contract=off -fPIC -shared -fopenmp -o libicon_host.so icon_host.cpp
echo "built $(pwd)/libicon_host.so"
