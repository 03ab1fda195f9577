.PHONY: native test bench longrun clean ci lint

native:
	python -c "from slamrs_tpu.native import build; print(build(force=True))"

test:
	python -m pytest tests/ -q

# syntax/bytecode floor (this image ships no linter; CI runs ruff too —
# see .github/workflows/ci.yml, the reference's clippy analog)
lint:
	python -m compileall -q slamrs_tpu tests bench.py __graft_entry__.py chip_smoke.py

# the local mirror of .github/workflows/ci.yml (reference hygiene:
# slamrs_rust.yml check+build+test+lint)
ci: lint native test
	python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

# long-horizon gates (full out.bin oracle parity + 500-update fused-vs-dda
# deviation); several minutes — not part of the default suite
longrun:
	SLAMRS_LONGRUN=1 python -m pytest tests/test_longrun.py -q -s

bench:
	python bench.py

clean:
	rm -f slamrs_tpu/native/*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
