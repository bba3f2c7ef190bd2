import sys

from mh_tpu.cli import main
from mh_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
sys.exit(main())
