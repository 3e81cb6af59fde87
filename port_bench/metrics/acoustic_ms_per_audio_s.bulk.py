"""acoustic_ms_per_audio_s.bulk: device ms of the acoustic model (encoder, variance adaptor, decoder) per second of audio delivered (program_spans.device_ms_per_audio_s)."""

from port_bench.program_spans import ACOUSTIC, device_ms_per_audio_s


def read(view):
    return device_ms_per_audio_s(view, ACOUSTIC)
