"""Signal-chain models: the OFDM modulator and ensemble transmitter (TX),
the streaming OFDM demodulator (RX front end) and the DAB receiver."""
