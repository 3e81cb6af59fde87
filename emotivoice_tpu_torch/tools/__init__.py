"""The port's user tools, each run as `python -m emotivoice_tpu_torch.tools.<name>`
and callable in one process as `main(argv)` (counterparts of the JAX
package's `tools/*.py` of the same names):

  synthesize_corpus         bulk synthesis of a text file (round-robin voices and prompts)
  sweep_voices              every speaker x prompt through the engine, with health gates
  verify_released_weights   load reference checkpoints, synthesize, compare with the reference
  prepare_ljspeech          LJSpeech -> 16 kHz wavs + train/valid datalists
  prepare_databaker         DataBaker (BZNSYP) -> 16 kHz wavs + train/valid datalists
  record_frontend_goldens   record / --check the frontend's golden fixture

Tools that run a model take `--device` (default cuda; without a card they
raise) and build their config through their module's `model_config()`.
"""
