"""argparse command line (``python -m bigstitcher_spark_tpu_torch.cli.main``)."""
