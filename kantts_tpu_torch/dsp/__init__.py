"""Signal processing of the port: STFT and mel spectrograms."""
