# Developer entry points (counterpart of the reference Makefile + CI scripts)
#
# Test tiers (measured 2026-08-20, single-core CPU, virtual 8-device mesh):
#   test        full suite            510 passed / ~21m
#   test-fast   -m "not slow"         423 passed /  7-12m load-dependent
#               (1 core; CI runs it with pytest-xdist -n auto)
#   test-smoke  --smoke               first 2 non-slow tests per module,
#                                     54 passed / 61s — every module still
#                                     imports and executes

.PHONY: test test-fast test-smoke bench smoke dryrun install native apidocs clean

apidocs:
	python scripts/gen_api_docs.py

install:
	pip3 install -e .

native:
	$(MAKE) -C physicl_tpu/utils/native

test:
	python -m pytest tests/ -x -q

test-fast:
	python -m pytest tests/ -x -q -m "not slow"

test-smoke:
	python -m pytest tests/ -x -q --smoke

bench:  # headline throughput on the GPU
	python bench.py

smoke:  # end-to-end proof on one GPU
	python chip_smoke.py

dryrun:
	python __graft_entry__.py dryrun 8

clean:
	rm -rf build dist *.egg-info physicl_tpu/utils/native/*.so .jax_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
