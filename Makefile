# Developer entry points, mirroring the reference's top-level Makefile
# (/root/reference/Makefile) with this repo's tooling.
SHELL = /bin/bash
PATHS = gymnasium_planar_robotics_tpu/ tests/ bench.py chip_smoke.py

pytest:
	python -m pytest tests/ -q

pytest-fast:
	python -m pytest tests/ -q -m "not slow"

format:
	ruff format $(PATHS)

check-codestyle:
	ruff check $(PATHS)

spelling:
	python docs/spellcheck.py

doc:
	JAX_PLATFORMS=cpu python docs/gen_api.py --check
	JAX_PLATFORMS=cpu python docs/build_site.py

native:
	$(MAKE) -C native/trajstore

bench:
	python bench.py

clean:
	rm -rf docs/_site native/trajstore/libtrajstore.so

commit: format check-codestyle spelling pytest doc

.PHONY: pytest pytest-fast format check-codestyle spelling doc native bench clean commit
