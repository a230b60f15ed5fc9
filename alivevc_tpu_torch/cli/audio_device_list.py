"""List audio devices (reference: audio_device_list.py); requires PyAudio,
imported when the listing runs."""

from __future__ import annotations


def main(argv=None):
    try:
        import pyaudio
    except ImportError:
        raise SystemExit("PyAudio is not installed in this image.")
    audio = pyaudio.PyAudio()
    print("list of available audio devices")
    for i in range(audio.get_device_count()):
        d = audio.get_device_info_by_index(i)
        asin = "o" if d["maxInputChannels"] >= 1 else "x"
        asout = "o" if d["maxOutputChannels"] >= 1 else "x"
        print(f"ID: {i}, Name: {d['name']} [Input: {asin} Output: {asout}]")


if __name__ == "__main__":
    main()
