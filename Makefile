# aerobulk_tpu build/test driver (replaces the reference's Makefile+arch layer:
# there is nothing to compile on the Python side; native targets cover cpp/).

PY ?= python3

.PHONY: test test-fast test-gpu bench bench-all smoke baseline cpp cpp-example toy clean

test:
	$(PY) -m pytest tests/ -x -q

test-fast:   # core correctness in <3 min; the slow marker holds the depth tests
	$(PY) -m pytest tests/ -x -q -m "not slow"

test-gpu:    # the tests marked gpu, on the card (they skip without one)
	JAX_PLATFORMS=cuda,cpu $(PY) -m pytest tests/ -x -q -m gpu

test-slow:   # just the depth tests (fuzz, long-series, heavy AD, sharded scans)
	$(PY) -m pytest tests/ -x -q -m "slow"

bench:
	$(PY) bench.py

bench-all:
	$(PY) bench.py --all

smoke:   # main path + kernels on the GPU, checked against the references
	$(PY) chip_smoke.py

baseline:   # measured single-core CPU baseline (C transcription)
	cc -O3 -march=native -ffast-math -o bench_baseline/coare36_skin_baseline \
	  bench_baseline/coare36_skin_baseline.c -lm
	./bench_baseline/coare36_skin_baseline 200000 5

cpp:
	cmake -S cpp -B cpp/build -G Ninja -DCMAKE_BUILD_TYPE=Release
	ninja -C cpp/build

cpp-example: cpp
	PYTHONPATH=$(CURDIR):$$PYTHONPATH ./cpp/build/example_call_aerobulk

toy:
	$(PY) -m aerobulk_tpu.cli toy

clean:
	rm -rf cpp/build aerobulk_tpu/__pycache__ tests/__pycache__
