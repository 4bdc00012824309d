"""Global constants of the modal sound engine.

These mirror the reference runtime contract (reference: config.h:11-14 and the
scale factors hard-coded around the reference's hot loop) so that data produced
for the reference can be consumed unchanged:

- ``SAMPLE_RATE`` / ``FRAMES_PER_BUFFER``: reference config.h:13-14.
- ``MODAL_GAIN``: the "arbitrary scaling" 1E9 applied to the c3 IIR input
  coefficient (reference modal_integrator.h:99).
- ``UNIT_TRANSFER``: the all-ones transfer level 1E7 used when FFAT maps are
  disabled or missing (reference modal_solver.h:89-92).
- ``OUTPUT_SCALE``: audio samples are divided by 1E10 before hitting the DAC
  (reference tools/real_time_modal_sound.cpp:207-210).
- ``DEFAULT_AUDIBLE_FREQ``: mode-culling threshold when no freq_threshold.txt
  exists (reference tools/real_time_modal_sound.cpp:327-329).

Device blocks are powers of two (the per-block FFT conv pads to 2S, and the
span's chunk sizes divide the block); ``FRAMES_PER_BUFFER`` (513, an odd size
inherited from the reference's PortAudio setup) is kept for parity renders,
while the native block size ``DEFAULT_BLOCK`` = 512 is used by the streaming
engine.
"""

SAMPLE_RATE = 44100
FRAMES_PER_BUFFER = 513          # reference block size (kept for parity)
DEFAULT_BLOCK = 512              # native device block size

MODAL_GAIN = 1e9                 # c3 gain        (modal_integrator.h:99)
UNIT_TRANSFER = 1e7              # unit transfer  (modal_solver.h:91)
OUTPUT_SCALE = 1e10              # output divisor (real_time_modal_sound.cpp:208)
DEFAULT_AUDIBLE_FREQ = 20000.0   # Hz             (real_time_modal_sound.cpp:328)

FILE_NOT_EXIST = "__NA_FILE"     # CLI sentinel   (config.h:11)

REBASE_PERIOD = 1 << 30          # samples between device-clock re-zeroes
#   (~6.7 h at 44.1 kHz; 2x headroom before int32 wrap even if a rebase
#   is missed for a full extra period). Shared by the session's rebase
#   (runtime/session.py::_maybe_rebase) and the counter-derived sustained
#   noise index (ops/forces.py::_noise_for_blocks), which wraps modulo
#   this period so live stepping and timeline bakes stay bit-identical
#   across the boundary.

SOUND_SPEED = 343.0              # m/s, air at ~20C; the value implied by the
#   FFAT wavenumbers k = omega/c the offline wavesolver fits against
#   (ffat_solver.h:44-53 h0(kr) kernel). Used by the beyond-reference
#   Doppler renderer (ops/doppler.py) — the reference itself applies no
#   propagation delay (modal_solver.h:286-300 holds the listener
#   block-constant).
