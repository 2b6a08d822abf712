"""``python -m mlmicroservicetemplate_tpu_torch`` -> serve."""

from .serve import main

if __name__ == "__main__":
    main()
