"""NYC-taxi fare regression on the torch compat estimator (the port's copy
of ``examples/torch_nyctaxi.py``, with the parts of
``examples/data_process.py`` it needs).

Direct counterpart of the reference's examples/pytorch_nyctaxi.py:
the SAME torch model/optimizer/loss configuration surface, trained
data-parallel (gloo DDP over the SPMD gang) from a DataFrame, on
``--device`` (default ``cuda``; ``cpu`` runs it on the host).

Run: python -m raydp_tpu_torch.cli.submit \\
         raydp_tpu_torch/examples/torch_nyctaxi.py [--smoke] [--device cpu]
"""
import argparse

import numpy as np
import pandas as pd

import raydp_tpu_torch
import raydp_tpu_torch.dataframe as rdf
from raydp_tpu_torch.dataframe import col, dayofweek, hour, udf


def synthetic_taxi(n_rows: int) -> pd.DataFrame:
    rng = np.random.default_rng(0)
    t0 = pd.Timestamp("2020-01-01")
    pickup = t0 + pd.to_timedelta(
        rng.integers(0, 365 * 24 * 3600, n_rows), unit="s"
    )
    trip_min = rng.gamma(2.0, 7.0, n_rows)
    pickup_lon = -73.98 + 0.1 * rng.standard_normal(n_rows)
    pickup_lat = 40.75 + 0.1 * rng.standard_normal(n_rows)
    dropoff_lon = -73.97 + 0.1 * rng.standard_normal(n_rows)
    dropoff_lat = 40.76 + 0.1 * rng.standard_normal(n_rows)
    # Fare follows the trip DISTANCE the features can reconstruct (plus a
    # duration term and noise) — so the estimator examples actually have
    # signal to learn, like the real NYC dataset.
    dist_km = np.hypot(
        (dropoff_lon - pickup_lon) * 84.3,  # km/deg at 40.75N
        (dropoff_lat - pickup_lat) * 111.1,
    )
    return pd.DataFrame(
        {
            "pickup_datetime": pickup,
            "dropoff_datetime": pickup + pd.to_timedelta(trip_min, unit="m"),
            "passenger_count": rng.integers(0, 7, n_rows),
            "pickup_longitude": pickup_lon,
            "pickup_latitude": pickup_lat,
            "dropoff_longitude": dropoff_lon,
            "dropoff_latitude": dropoff_lat,
            "fare_amount": np.maximum(
                2.5,
                2.5
                + 1.6 * dist_km
                + 0.3 * trip_min
                + rng.standard_normal(n_rows),
            ),
        }
    )


def nyc_taxi_preprocess(df: "rdf.DataFrame") -> "rdf.DataFrame":
    """The reference pipeline: drop bad rows, derive time + distance
    features, drop raw columns."""
    df = df.filter(
        (col("fare_amount") > 0) & (col("passenger_count") > 0)
    )
    df = df.withColumn("hour", hour(col("pickup_datetime")))
    df = df.withColumn("day_of_week", dayofweek(col("pickup_datetime")))

    @udf("double")
    def haversine(lon1, lat1, lon2, lat2):
        rad = np.pi / 180.0
        dlon = (lon2 - lon1) * rad
        dlat = (lat2 - lat1) * rad
        a = (
            np.sin(dlat / 2) ** 2
            + np.cos(lat1 * rad) * np.cos(lat2 * rad) * np.sin(dlon / 2) ** 2
        )
        return 6371.0 * 2 * np.arcsin(np.sqrt(a))

    df = df.withColumn(
        "distance_km",
        haversine(
            col("pickup_longitude"), col("pickup_latitude"),
            col("dropoff_longitude"), col("dropoff_latitude"),
        ),
    )
    return df.select(
        "hour", "day_of_week", "distance_km", "passenger_count",
        "fare_amount",
    )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--rows", type=int, default=100_000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    n_rows = 4_000 if args.smoke else args.rows
    epochs = 2 if args.smoke else 8

    import torch

    from raydp_tpu_torch.train import TorchEstimator

    # The reference example's model shape (examples/pytorch_nyctaxi.py).
    class TaxiNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = torch.nn.Linear(4, 256)
            self.fc2 = torch.nn.Linear(256, 128)
            self.fc3 = torch.nn.Linear(128, 1)

        def forward(self, x):
            x = torch.relu(self.fc1(x))
            x = torch.relu(self.fc2(x))
            return self.fc3(x)

    raydp_tpu_torch.init(app_name="torch-nyctaxi", num_workers=2)
    try:
        df = nyc_taxi_preprocess(
            rdf.from_pandas(synthetic_taxi(n_rows), num_partitions=4)
        )
        model = TaxiNet()
        est = TorchEstimator(
            num_workers=2,
            model=model,
            optimizer=torch.optim.Adam(model.parameters(), lr=1e-3),
            loss=torch.nn.SmoothL1Loss(),
            feature_columns=[
                "hour", "day_of_week", "distance_km", "passenger_count"
            ],
            label_column="fare_amount",
            batch_size=256,
            num_epochs=epochs,
            device=args.device,
        )
        history = est.fit_on_df(df)
        est.shutdown()
        first, last = history[0], history[-1]
        print(f"train_loss {first['train_loss']:.4f} -> "
              f"{last['train_loss']:.4f}")
        assert last["train_loss"] < first["train_loss"]
        print("torch_nyctaxi OK")
    finally:
        raydp_tpu_torch.stop()


if __name__ == "__main__":
    main()
