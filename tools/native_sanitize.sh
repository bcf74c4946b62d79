#!/bin/sh
# Sanitizer pass over the C host entropy stage (SURVEY §5.2).
#
# Builds the host library with UndefinedBehaviorSanitizer (and
# AddressSanitizer when AF_SAN=asan: python must LD_PRELOAD the asan
# runtime) and runs every native A/B test file against it.  The flags are
# part of the library's build key (host/native.py), so the sanitized
# build sits beside the normal one and never replaces it.  The tests
# compare C output bit-for-bit with the pure-python reference paths, so
# a sanitizer pass here covers the full per-format entropy surface.
#
#   tools/native_sanitize.sh            # UBSan (default)
#   AF_SAN=asan tools/native_sanitize.sh
set -e
cd "$(dirname "$0")/.."
LOGS=audio_formats_tpu/host/build
mkdir -p "$LOGS"
if [ "${AF_SAN:-ubsan}" = "asan" ]; then
  export AF_TPU_NATIVE_CFLAGS="-fsanitize=address,undefined -fno-sanitize-recover=all -g -O1"
  ASAN_RT=$(g++ -print-file-name=libasan.so)
  export LD_PRELOAD="$ASAN_RT"
  export ASAN_OPTIONS="detect_leaks=0:log_path=$LOGS/af_asan"   # CPython itself "leaks" arenas
elif [ "${AF_SAN:-ubsan}" = "tsan" ]; then
  # thread sanitizer over the concurrent host-stage driver (the batch
  # scheduler calls the C stage from main + worker threads)
  export AF_TPU_NATIVE_CFLAGS="-fsanitize=thread -g -O1"
  TSAN_RT=$(g++ -print-file-name=libtsan.so)
  export LD_PRELOAD="$TSAN_RT"
  export TSAN_OPTIONS="log_path=$LOGS/af_tsan:report_signal_unsafe=0"
else
  export AF_TPU_NATIVE_CFLAGS="-fsanitize=undefined -fno-sanitize-recover=all -g -O1"
  export UBSAN_OPTIONS="print_stacktrace=1:log_path=$LOGS/af_ubsan"
fi
if [ "${AF_SAN:-ubsan}" = "asan" ] || [ "${AF_SAN:-ubsan}" = "tsan" ]; then
  # jax-free driver: ASan/TSan preloaded runtimes clash with jaxlib's C++
  # exception handling, so they exercise the C surface directly (the
  # driver includes a concurrent two-thread section for TSAN)
  python tools/asan_driver.py
  status=$?
else
  JAX_PLATFORMS=cpu python -m pytest tests/test_native.py tests/test_celt_native.py \
      tests/test_mp3.py tests/test_flac.py tests/test_mp3_device_huff.py -q "$@"
  status=$?
fi
exit $status
