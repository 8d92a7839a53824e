# Convenience targets (see CLAUDE.md for environment notes)

.PHONY: test test-shuffled bench smoke examples native clean

test:
	python -m pytest tests/ -x -q

# order-independence pass: shuffled collection (any integer seed works)
test-shuffled:
	TEST_SHUFFLE_SEED=$${SEED:-1} python -m pytest tests/ -x -q

bench:
	python bench.py

smoke:
	python chip_smoke.py

examples:
	for ex in examples/ex*.py; do echo "== $$ex"; python $$ex || exit 1; done

native:
	g++ -O3 -shared -fPIC -std=c++17 -o xcontour_tpu/host/_libmarching.so csrc/marching.cpp

clean:
	rm -rf .pytest_cache xcontour_tpu/host/_libmarching.so
	find . -name __pycache__ -type d -exec rm -rf {} +
